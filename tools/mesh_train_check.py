#!/usr/bin/env python3
"""Data-parallel training and the MoE all-to-all on four cards, held to one
card.

  python3 -c 'import sys; sys.path.insert(0, "src"); from repro_torch.kernels.fault_inject import kernel; kernel.LIBRARY.build()'
  torchrun --nproc-per-node 4 tools/mesh_train_check.py [--json PATH]

(build K3/K4 once first: the ranks would each run nvcc). Every rank builds
the same seeded weights on its card.

(a) One aligned step (one4n rule, lr 1e-3) through ``run_training(mesh=)``
    on reduced olmo-1b over 4x1 and 2x2, and on reduced qwen3-moe with the
    all-to-all over "model" (the mesh set as the ambient one) over 2x2 and
    1x4, against the same step on rank 0's card alone (the all-to-all's
    ranks all run there: ``moe_a2a.apply_moe_a2a_local``): loss, accuracy,
    aux and grad norm within 1e-4 relative, gradients (AdamW's first
    moment, 0.1 g) within allclose(1e-4, 1e-5 of the leaf's largest),
    parameters within one fp16 ulp where the gradient exceeds 1e-6, and
    every rank's state bitwise rank 0's. The batch is 4 x 16 with
    IGNORE-masked labels, 12 of 64, unevenly over the rows.
(b) Full-width olmo-1b under the Fig. 7 schedule (one4n, BER 1e-4,
    dynamic, K4): 3 aligned steps on one card at 8 x 128, then on 4x1 at
    32 x 128 (8 rows a card); step ms (host clock after a synchronize;
    step 0 is the warm-up), tokens/s and each card's peak
    ``max_memory_allocated``; every rank's state bitwise rank 0's.
(c) qwen3-moe at its published widths, cut to 4 of its 94 layers (~45 GB
    of fp32 weights, so one card holds the one-card reference):
    the forward of a 4 x 256 batch on 1x4 with the all-to-all against the
    emulated per-slice dense dispatch on rank 0's card (logits within 1e-4
    of their largest), the MoE layer's forward ms on the mesh (CUDA
    events, rank 0) beside the emulated layer's on one card, and the
    exchanges' share: the layer's two all-to-alls, its all-gather and its
    aux all-reduce timed alone at the layer's shapes.

Rank 0 prints one JSON line a part, then the card's name and power limit,
and with ``--json PATH`` writes them all to PATH. Exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen3-moe-235b-a22b"
RTOL, ATOL, GRAD_FLOOR = 1e-4, 1e-5, 1e-6
REDUCED = (("olmo-1b", "4x1", False), ("olmo-1b", "2x2", False),
           (QWEN, "2x2", True), (QWEN, "1x4", True))
FULL_STEPS, FULL_SEQ, CARD_ROWS = 3, 128, 8
QWEN_LAYERS, QWEN_BATCH, QWEN_SEQ = 4, 4, 256
MOE_LEAVES = ("router", "moe_wgate", "moe_win", "moe_wout")


def _fp16_ulps(a, b):
    import torch
    ha = a.to(torch.float16).view(torch.int16).to(torch.int32)
    hb = b.to(torch.float16).view(torch.int16).to(torch.int32)
    return (ha - hb).abs()


@contextlib.contextmanager
def _in_process(data, model):
    """MoE layers take the all-to-all of a ``data x model`` mesh with every
    rank run on this card (``moe_a2a.apply_moe_a2a_local``): the one-card
    reference of the mesh's all-to-all."""
    from unittest import mock
    from repro_torch.models import moe_a2a

    def local(weights, cfg, x):
        return moe_a2a.apply_moe_a2a_local(weights, cfg, x, data, model)[:2]
    with mock.patch.object(moe_a2a, "route", lambda *_: True), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", local):
        yield


def _run(**kw):
    from repro_torch.configs import RunConfig
    from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy
    base = dict(steps=1, checkpoint_dir="", learning_rate=1e-3,
                warmup_steps=0, policy=ReliabilityPolicy(default=PolicyRule(
                    protect="one4n", n_group=8, index=2)))
    base.update(kw)
    return RunConfig(**base)


def _params(cfg, dev):
    import torch
    from repro_torch import convert
    from repro_torch.models.lm import LM
    model = LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    return convert.flat_from_lm(model)


def _batch(cfg):
    import numpy as np
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models.losses import IGNORE
    b = MarkovLM(cfg.vocab_size, 16, 4, seed=3).batch(0)
    labels = np.array(b["labels"])
    labels[0, :9] = IGNORE
    labels[-1, 5:8] = IGNORE
    return {"tokens": b["tokens"], "labels": labels}


def _step(cfg, dev, mesh, a2a):
    """One aligned step -> (metrics, params, first moments)."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.training import loop, steps
    run = _run()
    state = steps.init_train_state(None, cfg, run, params=_params(cfg, dev))
    with shlib.use_mesh(mesh if a2a else None):
        res = loop.run_training(cfg, run, iter([_batch(cfg)]), state=state,
                                mesh=mesh)
    return res.history[0], res.state.params, res.state.opt["m"]


def _held(got, want) -> dict:
    """The worst of each tolerance: metrics, gradients, parameters."""
    import torch
    (gm, gp, gg), (wm, wp, wg) = got, want
    out = {"metrics": max(abs(gm[k] - wm[k]) / (abs(wm[k]) or 1.0)
                          for k in ("loss", "accuracy", "grad_norm",
                                    "aux_loss"))}
    worst_g, worst_u = 0.0, 0
    for p, w in wp.items():
        g, h = gg[p] / 0.1, wg[p] / 0.1
        scale = float(h.abs().max()) or 1.0
        excess = ((g - h).abs() - RTOL * h.abs()) / (ATOL * scale)
        worst_g = max(worst_g, float(excess.max()))
        ulps = _fp16_ulps(gp[p], w)[h.abs() > GRAD_FLOOR]
        worst_u = max(worst_u, int(ulps.max()) if ulps.numel() else 0)
    out["gradient_excess_over_atol"] = worst_g      # <= 1 holds
    out["param_fp16_ulps"] = worst_u
    out["ok"] = out["metrics"] <= RTOL and worst_g <= 1 and worst_u <= 1 \
        and bool(torch.isfinite(torch.tensor(gm["loss"])))
    return out


def part_a(dev, rank0, report) -> bool:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    ok = True
    for arch, spec, a2a in REDUCED:
        cfg = get_config(arch).reduced()
        d, m = (int(v) for v in spec.split("x"))
        want = None
        if rank0:
            if a2a:
                with _in_process(d, m):
                    want = _step(cfg, dev, None, False)
            else:
                want = _step(cfg, dev, None, False)
        dist.barrier()
        mesh = mesh_lib.make_serve_mesh(spec, "cuda")
        got = _step(cfg, dev, mesh, a2a)
        same = shlib.same_on_every_rank(list(got[1].values()), mesh)
        if rank0:
            held = _held(got, want)
            held["same_on_every_rank"] = same
            ok = ok and held["ok"] and same
            line = {"part": "a", "arch": arch, "reduced": True, "mesh": spec,
                    "all_to_all": a2a, "loss": got[0]["loss"],
                    "one_card_loss": want[0]["loss"],
                    "aux_loss": got[0]["aux_loss"], **held}
            report.append(line)
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return ok


def _full_run(cfg, dev, mesh, rows):
    import torch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import loop, steps
    run = _run(steps=FULL_STEPS, ber=1e-4, inject="dynamic")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(gen, cfg, run, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = loop.run_training(cfg, run, iter(MarkovLM(
        cfg.vocab_size, FULL_SEQ, rows, seed=0)), state=state, mesh=mesh)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [h["step_time"] * 1e3 for h in res.history]
    steady = statistics.median(ms[1:])
    return res, {"step_ms": ms, "steady_ms": steady,
                 "tokens_per_s": rows * FULL_SEQ / steady * 1e3,
                 "losses": [h["loss"] for h in res.history],
                 "peak_gib": peak}


def part_b(dev, rank0, world, report) -> bool:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_config("olmo-1b")
    one = None
    if rank0:
        res, one = _full_run(cfg, dev, None, CARD_ROWS)
        del res
    torch.cuda.empty_cache()
    dist.barrier()
    mesh = mesh_lib.make_serve_mesh(f"{world}x1", "cuda")
    res, figs = _full_run(cfg, dev, mesh, CARD_ROWS * world)
    same = shlib.same_on_every_rank(list(res.state.params.values()), mesh)
    peaks = shlib.all_gather_objects(figs["peak_gib"], "data", mesh)
    del res
    torch.cuda.empty_cache()
    ok = same and all(x == x and abs(x) != float("inf")
                      for x in figs["losses"])
    if rank0:
        line = {"part": "b", "arch": "olmo-1b", "mesh": f"{world}x1",
                "batch": [CARD_ROWS * world, FULL_SEQ], **figs,
                "peak_gib_by_card": peaks, "same_on_every_rank": same,
                "one_card": {"batch": [CARD_ROWS, FULL_SEQ], **one}}
        report.append(line)
        print(json.dumps(line), flush=True)
    return ok


def _time_ms(fn, reps=5, inner=3) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def part_c(dev, rank0, world, report) -> bool:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm, moe_a2a
    cfg = dataclasses.replace(get_config(QWEN), n_layers=QWEN_LAYERS)
    mesh = mesh_lib.make_serve_mesh(f"1x{world}", "cuda")
    model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    gbytes = sum(p.numel() for p in model.parameters()) * 4 / 1e9
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (QWEN_BATCH, QWEN_SEQ),
                         generator=gen, device=dev)
    calls = []
    real = moe_a2a.apply_moe_a2a

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    with torch.no_grad():
        moe_a2a.apply_moe_a2a = counted
        try:
            with shlib.use_mesh(mesh):
                got = model(toks)
        finally:
            moe_a2a.apply_moe_a2a = real
        want = None
        if rank0:
            with _in_process(1, world):
                want = model(toks)
        # one MoE layer alone at the stack's first MoE input
        h = model.embed[toks]
        layer = model.blocks[0].moe
        with shlib.use_mesh(mesh):
            mesh_ms = _time_ms(lambda: layer(h))
        one_ms = None
        if rank0:
            with _in_process(1, world):
                one_ms = _time_ms(lambda: layer(h))
        # the layer's exchanges alone, at its shapes
        tl = QWEN_BATCH * QWEN_SEQ // world
        c = max(8, -(-tl * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
        c = int(c)
        send = torch.randn(world, cfg.n_experts // world * c, cfg.d_model,
                           device=dev)
        out_blk = torch.randn(QWEN_BATCH, QWEN_SEQ // world, cfg.d_model,
                              device=dev)
        aux = torch.zeros((), device=dev)

        def exchanges():
            shlib.all_to_all(send, "model", mesh)
            shlib.all_to_all(send, "model", mesh)
            shlib.all_gather(out_blk, "model", mesh, dim=1)
            shlib.all_reduce_mesh(aux.clone(), mesh)
        exch_ms = _time_ms(exchanges)
    ok = len(calls) == QWEN_LAYERS
    if rank0:
        err = float((got - want).abs().max()) / float(want.abs().max())
        ok = ok and err <= RTOL and bool(torch.isfinite(got).all())
        line = {"part": "c", "arch": QWEN, "layers": QWEN_LAYERS,
                "of_layers": 94, "weights_gb": gbytes, "mesh": f"1x{world}",
                "batch": [QWEN_BATCH, QWEN_SEQ], "a2a_calls": len(calls),
                "capacity": c, "logits_rel_err": err,
                "moe_layer_ms_mesh": mesh_ms,
                "moe_layer_ms_one_card_emulated": one_ms,
                "exchanges_ms": exch_ms,
                "exchanges_share": exch_ms / mesh_ms, "ok": ok}
        report.append(line)
        print(json.dumps(line), flush=True)
    del model
    torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write rank 0's report to PATH")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    world = mesh_lib.init_world("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch.device import resolve_device
    resolve_device(dev)                  # TF32 off
    rank0 = dist.get_rank() == 0
    report, ok = [], True
    t0 = time.perf_counter()
    try:
        for part in (lambda: part_a(dev, rank0, report),
                     lambda: part_b(dev, rank0, world, report),
                     lambda: part_c(dev, rank0, world, report)):
            ok = part() and ok
            dist.barrier()
    finally:
        mesh_lib.destroy_world()
    if rank0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "world": world, "ok": ok,
                 "seconds": time.perf_counter() - t0, "parts": report},
                indent=1))
        print(f"mesh_train_check: ok={ok} in "
              f"{time.perf_counter() - t0:.1f} s")
        print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
