"""Plain PyTorch versions of the fault-injection kernels (port of
``repro/kernels/fault_inject/ref.py``; same counter-based PRNG).

They state what K3/K4 compute. Words are widened to ``int64`` and masked to
32 bits (as :func:`hash_u32` takes them), then narrowed back to the plane's
storage type. The CPU route of :mod:`.ops` runs them, and the tests
and ``chip_smoke.py`` hold the kernels to them. K4 over a run table
(:func:`fault_inject_runs_ref`) is :func:`fault_inject_ref` a run at a
time, with the round trip of a float32 plane through
``bitops.to_bits`` / ``bitops.fp16_bits_to_f32`` around it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bitops
from repro_torch.kernels.fault_inject.kernel import seed_words, static_threshold

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9


def hash_u32(z):
    """murmur3 32-bit finalizer with wrapping uint32 arithmetic.

    Takes a Python int or an ``int64`` tensor of uint32 values. The input is
    masked first and every product after, so every right shift is logical
    (an int64 ``>>`` is arithmetic) and an overflowing int64 product keeps
    its correct low 32 bits."""
    z = z & M32
    z = z ^ (z >> 16)
    z = (z * 0x85EBCA6B) & M32
    z = z ^ (z >> 13)
    z = (z * 0xC2B2AE35) & M32
    z = z ^ (z >> 16)
    return z


def _elem(r: int, c: int, device) -> torch.Tensor:
    return torch.arange(r * c, dtype=torch.int64, device=device).reshape(r, c)


def _flip(bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    wide = bits.to(torch.int64) & M32
    return (wide ^ mask).to(bits.dtype)


def fault_inject_ref(bits: torch.Tensor, *, seed: int, ber: float,
                     positions: Sequence[int], at=None) -> torch.Tensor:
    """K4's function: ``positions`` of ``bits [R, C]`` flipped at rate
    ``ber`` from one seed (double-precision threshold); with ``at =
    (row_off, col_off, width)`` element (r, c) draws at counter
    ``(row_off + r) * width + col_off + c``."""
    r, c = bits.shape
    threshold = static_threshold(ber)
    if at is None:
        elem = _elem(r, c, bits.device)
    else:
        row_off, col_off, width = (int(v) for v in at)
        elem = (torch.arange(row_off, row_off + r, dtype=torch.int64,
                             device=bits.device)[:, None] * width
                + torch.arange(col_off, col_off + c, dtype=torch.int64,
                               device=bits.device)[None])
    seed_mul = (int(seed) * GOLD) & M32
    mask = torch.zeros((r, c), dtype=torch.int64, device=bits.device)
    for p in positions:
        z = ((elem * 32 + int(p)) & M32) ^ seed_mul
        mask |= (hash_u32(z) < threshold).to(torch.int64) << int(p)
    return _flip(bits, mask)


def fault_inject_runs_ref(x: torch.Tensor, runs, *, seed: int, ber: float,
                          positions: Sequence[int], col_off: int = 0,
                          width: int = None, fold: bool = True,
                          out: torch.Tensor = None) -> torch.Tensor:
    """K4 over a run table: run ``(r0, k, row_off)`` holds rows ``r0`` up to
    the next run's ``r0`` of ``x [R, C]`` and draws them with
    :func:`fault_inject_ref` at ``(row_off, col_off, width)`` from
    ``fold_seed(seed, k)`` (``fold``) or ``seed``. ``x`` is uint16 bits, or
    float32 values taken to fp16 bits and back. The result goes to ``out``
    (``x`` for in place) or a new plane."""
    # lazy import: core.cim imports this module through ops
    from repro_torch.core.cim import fold_seed
    r, c = x.shape
    width = c if width is None else int(width)
    out = torch.empty_like(x) if out is None else out
    bits_out = x.dtype == torch.uint16
    # uint16 rows are copied through their int16 views (no uint16 copy on
    # CUDA)
    dst = out.view(torch.int16) if bits_out else out
    ends = [int(r0) for r0, _, _ in runs[1:]] + [r]
    for (r0, k, row_off), r1 in zip(runs, ends):
        rows = x[r0:r1]
        drawn = fault_inject_ref(
            rows if bits_out else bitops.to_bits(rows),
            seed=fold_seed(seed, k) if fold else seed, ber=ber,
            positions=positions, at=(row_off, col_off, width))
        dst[r0:r1] = drawn.view(torch.int16) if bits_out \
            else bitops.fp16_bits_to_f32(drawn)
    return out


def fault_inject_batched_ref(bits: torch.Tensor, seeds, threshold, *,
                             positions: Sequence[int], m_thr=0, m_len=0,
                             model_kind: str = "iid", model_axis: str = "row",
                             col_div: int = 1, at=None) -> torch.Tensor:
    """K3's function: ``[R, C]`` x seeds ``[T]`` -> ``[T, R, C]``; trial t
    equals :func:`fault_inject_ref` at ``seed=seeds[t]`` for a matching
    threshold. ``model_kind``/``model_axis`` with the ``m_thr``/``m_len``
    payload scale the threshold per element (burst, correlated), from the
    element's global index in the plane of width C (``col_div`` words a
    macro-column unit) and the trial's seed; ``iid``/``drift`` keep it.
    ``at = (col_off, global_cols)``: the plane is that column block of a
    ``[R, global_cols]`` plane, and each element draws at its index there
    (``cim.global_elem``), under that plane's geometry."""
    # lazy imports: faultmodels imports hash_u32 from here, cim this module
    from repro_torch.core.cim import global_elem
    from repro_torch.core.faultmodels import scale_elem_thresholds
    r, c = bits.shape
    col_off, width = (0, c) if at is None else (int(v) for v in at)
    threshold = int(threshold) & M32
    elem = global_elem((r, c), (r, width), 1, col_off,
                       bits.device)[None]                        # [1, R, C]
    seeds = torch.from_numpy(seed_words(seeds).astype("int64")).to(bits.device)
    seed_mul = ((seeds * GOLD) & M32)[:, None, None]              # [T, 1, 1]
    thr = scale_elem_thresholds(elem, threshold, seeds[:, None, None],
                                kind=model_kind, axis=model_axis, m_thr=m_thr,
                                m_len=m_len, width=width, col_div=col_div)
    mask = torch.zeros((seeds.numel(), r, c), dtype=torch.int64,
                       device=bits.device)
    for p in positions:
        z = ((elem * 32 + int(p)) & M32) ^ seed_mul
        mask |= (hash_u32(z) < thr).to(torch.int64) << int(p)
    return _flip(bits[None], mask)
