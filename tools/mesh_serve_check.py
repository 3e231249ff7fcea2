#!/usr/bin/env python3
"""Serve full-width olmo-1b on a multi-card mesh and hold it to one card.

  torchrun --nproc-per-node 2 tools/mesh_serve_check.py --mesh 1x2
  torchrun --nproc-per-node 4 tools/mesh_serve_check.py --mesh 2x2

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DxM")
    ap.add_argument("--rounds", type=int, default=2)
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
    mesh = mesh_lib.make_serve_mesh(args.mesh, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    model = LM(get_config("olmo-1b"),
               generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    rank0 = dist.get_rank() == 0
    ok = True
    try:
        for label, protect, inject in ARMS:
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
