#!/usr/bin/env python3
"""Serve full-width olmo-1b on a multi-card mesh and hold it to one card.

  torchrun --nproc-per-node 2 tools/mesh_serve_check.py --mesh 1x2
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 2x2
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 1x4 --engine
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 1x2 --fleet 2
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 2x2 --sweep

Every rank builds the same seeded weights on its card. For the lock-step
arms (a) fused one4n dynamic, (b) fused none dynamic and (c) fused one4n
static (BER 1e-4, batch 4, prompt 64, gen 32, ``--rounds`` rounds), the
script serves through
``serve(mesh=make_serve_mesh(spec))`` (NCCL; the unembed column-sharded over
"model", the batch rows over "data") and then through ``serve`` on each
rank's card alone, and fails unless every round's tokens and the ECC totals
are equal. Arm (c)'s static image holds corrected codewords (the script
fails if it counts none), so its totals show the sum over "model". Rank 0 prints one JSON line per arm (tok/s aggregate and a
device, the one-card run's tok/s, this rank's K1/K2 launches), then the
card's name and power limit.

``--engine``: the continuous-batching engine's arm (a) (fused one4n
dynamic, BER 1e-4, ECC accounting on) over a LoadGen of 8 requests
(prompts 8-32, generations 4-16, a shared 32-token prefix and a prefix
cache), 4 slots, chunk 16, on the mesh (stores over "model", the slots over
"data" when it divides them) and on each rank's card alone: every
request's tokens and ECC charges must be equal, and its logits bitwise
where "data" is 1 (else within 1e-5 of the largest: the decode products
run at fewer rows a rank). ``--fleet N``: the same load through N replicas
on blocks of D x M ranks (``make_fleet_meshes``; the world is N x D x M),
held to the one-card engine the same way. ``--sweep``: Fig. 6's one4n arm
at BER 1e-3, 4 trials, on the mesh read as ("trial", "model"): its cells
must equal the one-card arm's. Each prints one JSON line (rank 0) with its
wall seconds and tok/s beside the one-card run's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = (("a fused one4n dynamic", "one4n", "dynamic"),
        ("b fused none dynamic", "none", "dynamic"),
        ("c fused one4n static", "one4n", "static"))


ENGINE_LOAD = dict(n_requests=8, prompt_lens=(8, 32), gen_lens=(4, 16),
                   seed=0, prefix_len=32)


def _same(a, b, rtol) -> bool:
    """Tokens and ECC charges equal, logits bitwise (``rtol`` None) or
    within ``rtol`` of the largest logit."""
    import numpy as np
    if a.tokens != b.tokens or a.ecc != b.ecc or a.ecc_window != b.ecc_window:
        return False
    if rtol is None:
        return a.logits.tobytes() == b.logits.tobytes()
    return float(np.abs(a.logits - b.logits).max()) <= \
        rtol * float(np.abs(b.logits).max())


def _engine_arm(model, mesh, n_fleet: int, meshes):
    """Engine arm (a) on the mesh (or a fleet over ``meshes``) against the
    one-card engine -> the JSON record."""
    import time
    import torch
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import fleet as fleet_lib
    from repro_torch.launch import serve as serve_lib
    static, dynamic = serve_lib.default_seeds(0, model.cim_leaves())
    dep = serve_lib.make_deployment(
        model.cim_leaves(), ber=1e-4, protect="one4n", n_group=8, index=2,
        seeds=static, inject_mode="dynamic", field="full")
    kw = serve_lib.serving_kw(ber=1e-4, dynamic_seeds=dynamic,
                              inject_mode="dynamic", field="full")
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size,
                              **ENGINE_LOAD)
    reqs, max_len = load.requests(), load.max_len()
    ekw = dict(n_slots=4, max_len=max_len, chunk=16, collect_logits=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    own = mesh if meshes is None else meshes[meshes.replica]
    placed = dep.shard(own).serving_params(**kw)
    if meshes is None:
        (res, agg), secs = timed(lambda: engine_lib.Engine(
            model, placed, prefix_cache=True, mesh=mesh, **ekw).run(reqs))
    else:
        spool = str(ROOT / "build" / "mesh_fleet_spool")
        (res, agg), secs = timed(lambda: fleet_lib.Fleet.from_serving_params(
            model, placed, n_replicas=n_fleet, meshes=meshes,
            spool_dir=spool, **ekw).run(reqs))
    (one, one_agg), one_s = timed(lambda: engine_lib.Engine(
        model, dep.serving_params(**kw), prefix_cache=True, **ekw).run(reqs))
    rtol = None if shlib.batch_ranks(own) == 1 else 1e-5
    same = sorted(res) == sorted(one) and all(
        _same(res[r], one[r], rtol) for r in one)
    tokens = sum(len(r.tokens) for r in res.values())
    return same, {
        "arm": "fleet" if meshes is not None else "engine",
        "replicas": n_fleet or 1, "equal_to_one_card": same,
        "logits": "bitwise" if rtol is None else f"within {rtol}",
        "wall_s": secs, "tok_s": tokens / secs,
        "decode_tok_s": agg.get("decode_tok_s"),
        "one_card_wall_s": one_s, "one_card_tok_s": tokens / one_s,
        "one_card_decode_tok_s": one_agg["decode_tok_s"],
        "prefix_hits": agg["prefix_hits"], "ecc": agg["ecc"]
        if "ecc" in agg else one_agg["ecc"],
        "requests_by_replica": agg.get("requests_by_replica")}


def _sweep_arm(model, mesh):
    """Fig. 6's one4n arm at BER 1e-3 on the (trial, model) mesh against
    one card -> (equal, record)."""
    import time
    import torch
    from repro_torch import convert
    from repro_torch.core import cim
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import lm
    dev = model.embed.device
    params = convert.flat_from_lm(model)
    toks = torch.from_numpy(MarkovLM(model.cfg.vocab_size, 64, 4, seed=0)
                            .batch(0)["tokens"]).long().to(dev)
    cim_cfg = cim.CIMConfig(n_group=8, index=2)
    _, aligned = cim.deploy_pytree_impl(params, cim_cfg)
    with torch.no_grad():
        clean = lm.forward(model, aligned, toks).argmax(-1)
    del aligned

    def agreement(p):
        with torch.no_grad():
            return (lm.forward(model, p, toks).argmax(-1) == clean) \
                .to(torch.float32).mean()
    plan = sweep_lib.SweepPlan(bers=(1e-3,), n_trials=4, protects=("one4n",))
    seeds = sweep_lib.default_seeds(6, 1, 1, 4)

    def timed(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            rows = eng.run_protection(seeds, params, agreement, cim_cfg)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0
    rows, secs = timed(sweep_lib.SweepEngine(plan, device=dev, mesh=mesh))
    one, one_s = timed(sweep_lib.SweepEngine(plan, device=dev))
    cells = [(r.accuracies, r.trial_corrected, r.trial_uncorrectable)
             for r in rows]
    same = cells == [(r.accuracies, r.trial_corrected,
                      r.trial_uncorrectable) for r in one]
    return same, {"arm": "sweep", "equal_to_one_card": same, "wall_s": secs,
                  "one_card_wall_s": one_s, "agreement": rows[0].mean,
                  "corrected": rows[0].corrected,
                  "uncorrectable": rows[0].uncorrectable}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DxM")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--fleet", type=int, default=0, metavar="N")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.cim_read import kernel as kernel_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    meshes = None
    if args.fleet:
        from repro_torch.launch import fleet as fleet_lib
        meshes = fleet_lib.make_fleet_meshes(args.mesh, args.fleet, "cuda")
        mesh = meshes[meshes.replica]
    elif args.sweep:
        t_ax, m_ax = (int(v) for v in args.mesh.split("x"))
        mesh = mesh_lib.make_sweep_mesh(m_ax, t_ax * m_ax, "cuda")
    else:
        mesh = mesh_lib.make_serve_mesh(args.mesh, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    model = LM(get_config("olmo-1b"),
               generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    rank0 = dist.get_rank() == 0
    ok = True
    try:
        if args.engine or args.fleet or args.sweep:
            same, rec = _sweep_arm(model, mesh) if args.sweep else \
                _engine_arm(model, mesh, args.fleet, meshes)
            ok = same
            if rank0:
                print(json.dumps({"mesh": args.mesh, **rec}))
        for label, protect, inject in ARMS if not (
                args.engine or args.fleet or args.sweep) else ():
            kw = dict(batch=4, prompt_len=64, gen=32, seed=0, cim=True,
                      ber=1e-4, protect=protect, serve_path="fused",
                      inject=inject, rounds=args.rounds, verbose=False)
            kernel_lib.reset_launch_counts()
            sharded = serve_lib.serve(model, mesh=mesh, **kw)
            launches = dict(kernel_lib.launch_counts)
            single = serve_lib.serve(model, **kw)
            same = bool(np.array_equal(sharded["round_tokens"],
                                       single["round_tokens"])
                        and sharded["ecc"] == single["ecc"])
            counted = inject == "dynamic" or single["ecc"]["corrected"] > 0
            ok = ok and same and counted
            if rank0:
                print(json.dumps({
                    "mesh": args.mesh, "arm": label, "rounds": args.rounds,
                    "tokens_and_ecc_equal": same,
                    "static_image_counts_corrected": counted,
                    "tok_per_s": sharded["tok_per_s"],
                    "tok_per_s_device": sharded["tok_per_s_device"],
                    "one_card_tok_per_s": single["tok_per_s"],
                    "launches_rank0": launches, "ecc": sharded["ecc"]}))
    finally:
        mesh_lib.destroy_world()
    if rank0:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
              .splitlines()[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
