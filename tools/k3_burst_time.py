#!/usr/bin/env python3
"""Time K3 under each burst process, in a given checkout.

  python3 tools/k3_burst_time.py [--root DIR] [--json PATH]   # one CUDA card

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so that
two checkouts (e.g. a parent unpacked with ``git archive`` into a
git-ignored directory) can be timed in turn in one call on one card. The
planes are seeded random words at the shapes of ``chip_smoke.py`` phase 7
and of Fig. 6's one4n arm (olmo-1b, K = 2048, J = 50304), T = 4 trials at
BER 1e-3 through ``ops.fault_inject_bits_batched``:

* the unembed's mantissa plane [2048, 50304] uint16, 10 positions, under
  burst row / col (rate 0.25, length 4) and bank (length 8), then i.i.d.
  and correlated (strength 0.8, period 4), which take the other kernel;
* Fig. 6's ``burst:rate=0.5,length=4`` (row axis) on that plane, on the
  embed's mantissa plane [50304, 2048] and on the unembed's flattened
  codeword plane [256, 25152] uint32 (32 positions, col_div S*W = 8).

Each case: the median of CUDA-event runs (5 x 5 calls after 3 warm-ups),
K3's launches a call, the draws the call performs (the live elements of
each trial, from the plain version's thresholds, times the positions) and
the bound (the larger of those draws at 10 ALU-pipe ops and 16.75 T op/s
and the bytes ``w * n * (1 + T)`` at 3.35 TB/s), and a digest of one
call's result, so two checkouts' copies can be compared. Prints one JSON
line and the card's name and power limit.
"""
from __future__ import annotations

import sys

from chip_timing import checkout, digest, emit, time_ms

K, J = 2048, 50304
T, BER = 4, 1e-3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT32_OPS = 67e12 / 4            # the ALU pipe: 64 INT32 lanes an SM
ALU_OPS_PER_DRAW = 10
FIG6_BURST = "burst:rate=0.5,length=4"
# (name, plane, spec, positions, col_div)
CASES = (("man row", "man", "burst:rate=0.25,length=4,axis=row", 10, 1),
         ("man col", "man", "burst:rate=0.25,length=4,axis=col", 10, 1),
         ("man bank", "man", "burst:rate=0.25,length=8,axis=bank", 10, 1),
         ("man iid", "man", None, 10, 1),
         ("man correlated", "man", "correlated:strength=0.8,period=4", 10, 1),
         ("fig6 man", "man", FIG6_BURST, 10, 1),
         ("fig6 embed man", "embed", FIG6_BURST, 10, 1),
         ("fig6 codewords", "cw", FIG6_BURST, 32, 8))


def _draws(plane, seeds, thr, spec, positions, col_div) -> int:
    """Draws the call performs: every element of every trial under i.i.d.
    or correlated, the live ones under burst."""
    import torch
    from repro_torch.core import faultmodels as fm
    model = fm.parse_fault_model(spec)
    if model is None or model.kind != "burst":
        return plane.numel() * len(seeds) * positions
    m_thr, m_len = fm.model_scalars(model)
    r, c = plane.shape
    elem = torch.arange(r * c, dtype=torch.int64,
                        device=plane.device).reshape(r, c)
    live = 0
    for sd in seeds:
        live += int((fm.scale_elem_thresholds(
            elem, thr, int(sd), kind="burst", axis=model.axis, m_thr=m_thr,
            m_len=m_len, width=c, col_div=col_div) != 0).sum())
    return live * positions


def main(argv=None) -> int:
    args = checkout("k3_burst_time", argv)
    if args is None:
        return 2
    import numpy as np
    import torch
    from repro_torch.kernels.fault_inject import kernel as fi_kernel
    from repro_torch.kernels.fault_inject import ops
    dev = torch.device("cuda")
    fi_kernel.LIBRARY.load()
    gen = torch.Generator(device=dev).manual_seed(29)

    def words(shape, bits):
        w = torch.randint(-2 ** (bits - 1), 2 ** (bits - 1), shape,
                          generator=gen, dtype=torch.int64, device=dev)
        return w.to(torch.int16).view(torch.uint16) if bits == 16 \
            else w.to(torch.int32)
    planes = {"man": words((K, J), 16), "embed": words((J, K), 16),
              "cw": words((K // 8, J // 16 * 2 * 4), 32)}
    seeds = np.asarray([0x1234567, 0xDEADBEEF, 7, 2 ** 31 + 11], np.uint32)
    thr = ops.ber_to_threshold(BER)
    out = {"root": str(args.root), "trials": T, "ber": BER, "cases": {}}
    for name, key, spec, n_pos, col_div in CASES:
        plane = planes[key]

        def call():
            return ops.fault_inject_bits_batched(
                plane, seeds, thr, positions=range(n_pos), model=spec,
                col_div=col_div)
        fi_kernel.reset_launch_counts()
        one = call()
        torch.cuda.synchronize()
        launches = fi_kernel.launch_counts[fi_kernel.K3]
        sha = digest(one)
        del one
        ms = time_ms(call)
        draws = _draws(plane, seeds, thr, spec, n_pos, col_div)
        nbytes = plane.numel() * plane.element_size() * (1 + T)
        ops_ms = draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out["cases"][name] = {
            "spec": spec or "iid", "shape": list(plane.shape),
            "dtype": str(plane.dtype), "positions": n_pos,
            "col_div": col_div, "ms": ms, "launches": launches,
            "draws": draws, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": max(ops_ms, bytes_ms) / ms, "digest": sha}
    emit(out, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
