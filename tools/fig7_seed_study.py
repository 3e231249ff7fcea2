#!/usr/bin/env python3
"""The Fig. 7 dynamic-injection claim over many seeds, on both packages.

  PYTHONPATH=src python3 tools/fig7_seed_study.py --seeds 10 \\
      --json build/fig7_seed_study.json        # from the repository root

Runs ``tests/test_fault_tolerance.py::test_dynamic_injection_protected_vs_not``'s
setting (reduced olmo-1b, ``MarkovLM(vocab, 32, 2, seed=0)``, 8 steps,
BER 2e-3, dynamic injection, One4N against no protection) once per run
seed ``0 .. seeds-1`` on the JAX reference (``--side jax``), on the
PyTorch port on the CPU (``--side torch``) or on both (the default). Each
side draws its own initial weights and its own fault stream from the seed:
the reference's ``jax.random`` key chain, the port's counter PRNG. Prints
one line a run and, per side and protection, the share of runs with a
non-finite loss, the median last loss (a non-finite one counts as +inf),
and the share of seeds where the reference test's claim holds (One4N
finite, and ``none`` non-finite or its last loss 0.5 above One4N's).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time
import warnings

BER, STEPS, SEQ, BATCH = 2e-3, 8, 32, 2
PROTECTS = ("one4n", "none")


def _jax_losses(seed: int, protect: str) -> list:
    from repro.configs import RunConfig, get_config
    from repro.core.api import ReliabilityConfig
    from repro.data.synthetic import MarkovLM
    from repro.training.loop import run_training
    cfg = get_config("olmo-1b").reduced()
    rel = ReliabilityConfig(mode="cim", ber=BER, protect=protect,
                            inject="dynamic")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        run = RunConfig(arch="olmo-1b", steps=STEPS, seed=seed,
                        checkpoint_dir="", reliability=rel, remat=False)
    data = MarkovLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    _, hist, _ = run_training(cfg, run, iter(data))
    return [float(h["loss"]) for h in hist]


def _torch_losses(seed: int, protect: str) -> list:
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training.loop import run_training
    cfg = get_config("olmo-1b").reduced()
    run = RunConfig(steps=STEPS, seed=seed, checkpoint_dir="", ber=BER,
                    inject="dynamic", policy=ReliabilityPolicy(
                        default=PolicyRule(protect=protect)))
    data = MarkovLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    res = run_training(cfg, run, iter(data), device="cpu")
    return [float(h["loss"]) for h in res.history]


def _last(losses: list) -> float:
    return losses[-1] if all(math.isfinite(x) for x in losses) else math.inf


def claim_holds(good: list, bad: list) -> bool:
    """The reference test's assertion on one seed's two runs."""
    if not all(math.isfinite(x) for x in good):
        return False
    return (not all(math.isfinite(x) for x in bad)) \
        or bad[-1] > good[-1] + 0.5


def summarize(runs: dict) -> dict:
    """``runs[protect] = [losses of seed 0, ...]`` -> figures a side."""
    out = {}
    for p, per_seed in runs.items():
        lasts = [_last(x) for x in per_seed]
        out[p] = {"nonfinite_share": sum(math.isinf(x) for x in lasts)
                  / len(lasts), "median_last_loss": statistics.median(lasts)}
    pairs = list(zip(runs["one4n"], runs["none"]))
    out["claim_share"] = sum(claim_holds(g, b) for g, b in pairs) / len(pairs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--side", choices=("jax", "torch", "both"),
                    default="both")
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    sides = ("jax", "torch") if args.side == "both" else (args.side,)
    fns = {"jax": _jax_losses, "torch": _torch_losses}
    result = {"settings": {"ber": BER, "steps": STEPS, "seq": SEQ,
                           "batch": BATCH, "seeds": args.seeds}}
    for side in sides:
        runs = {p: [] for p in PROTECTS}
        for seed in range(args.seeds):
            for p in PROTECTS:
                t = time.perf_counter()
                losses = fns[side](seed, p)
                runs[p].append(losses)
                print(f"{side} seed {seed} {p}: losses "
                      f"{[round(x, 4) for x in losses]} "
                      f"({time.perf_counter() - t:.1f} s)", flush=True)
        summary = summarize(runs)
        print(f"{side}: {json.dumps(summary)}", flush=True)
        result[side] = {"runs": runs, "summary": summary}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
