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

import sys

from chip_timing import checkout, digest, emit, time_ms

SHAPE = (40, 4096, 12800)
PATH = "groups/blk0/mlp/w_gate"


def main(argv=None) -> int:
    args = checkout("k4_block_time", argv)
    if args is None:
        return 2
    import torch
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
        sha = digest(one.view(torch.int16))
        del one
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(fn, reps=3, inner=3)
        out[name] = {"ms": ms, "launches": launches, "digest": sha,
                     "peak_extra_gib": (torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30}
    emit(out, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
