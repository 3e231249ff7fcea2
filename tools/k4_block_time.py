#!/usr/bin/env python3
"""Time K4 on one rank's block of a sharded leaf, in a given checkout.

  python3 tools/k4_block_time.py [--root DIR] [--json PATH]   # one CUDA card

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so that
two checkouts (e.g. a parent unpacked with ``git archive`` into a
git-ignored directory) can be timed in turn in one call on one card. The
block is the 4x1 ``data`` block [40 x 1024, 12800] at offset 1024 of
granite-3-8b's stacked w_gate [40, 4096, 12800] (the block phase 17 (a) of
``chip_smoke.py`` times), 10 mantissa positions at BER 1e-4:

* ``u16``: ``fault.draw_block_bits`` on its uint16 plane;
* ``f32``: ``fault.inject_block(..., "mantissa", in_place=True)`` on
  fp16-grid float32 weights (the Fig. 7 schedule's call on a block);

each the median of CUDA-event runs (3 x 3 calls after 3 warm-ups), with K4's
launches a call (``launch_counts``) and a digest of one call's result, so
two checkouts' draws can be compared. Prints one JSON line and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (40, 4096, 12800)
PATH = "groups/blk0/mlp/w_gate"


def _time_ms(fn, reps: int = 3, inner: int = 3) -> float:
    import torch
    for _ in range(3):
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
    return sorted(times)[len(times) // 2]


def _digest(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("k4_block_time: torch.cuda is not available", file=sys.stderr)
        return 2
    from repro_torch.core import fault
    from repro_torch.distributed import sharding as shlib
    from repro_torch.kernels.fault_inject import kernel as fi_kernel
    from repro_torch.launch import specs
    dev = torch.device("cuda")
    fi_kernel.LIBRARY.load()
    rank = shlib.ranks_of(("data", "model"), (4, 1))[1]
    lay = shlib.layout_of(specs.leaf_spec(rank, PATH, torch.empty(
        SHAPE, device="meta")), SHAPE, rank)
    gen = torch.Generator(device=dev).manual_seed(17)
    rows, cols = lay.block[0] * lay.block[1], lay.block[2]
    bits = torch.randint(-2 ** 15, 2 ** 15, (rows, cols), generator=gen,
                         dtype=torch.int16, device=dev).view(torch.uint16)
    w = (torch.randn((rows, cols), generator=gen, device=dev) * 0.02) \
        .half().float()
    seed, ber, positions = 0x5EED, 1e-4, tuple(range(10))
    out = {"root": str(args.root), "block": list(lay.block),
           "offsets": list(lay.offsets)}
    for name, fn in (
            ("u16", lambda: fault.draw_block_bits(bits, lay, seed, ber,
                                                  positions)),
            ("f32", lambda: fault.inject_block(seed, w, lay, ber, "mantissa",
                                               in_place=True))):
        fi_kernel.reset_launch_counts()
        one = fn()
        torch.cuda.synchronize()
        launches = sum(fi_kernel.launch_counts.values())
        digest = _digest(one.view(torch.int16))
        del one
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _time_ms(fn)
        out[name] = {"ms": ms, "launches": launches, "digest": digest,
                     "peak_extra_gib": (torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out["card"] = card
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "a") as f:
            f.write(line + "\n")
    print(line)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
