"""Bind the hand-written CUDA fault-injection kernels of
``csrc/fault_inject.cu`` (port of ``repro/kernels/fault_inject/kernel.py``).

* K3 :func:`fault_inject_batched` replaces ``fault_inject_batched_pallas``:
  ``bits [R, C]`` (uint8, uint16 or uint32 held in int32) and trial seeds
  ``[T]`` -> ``[T, R, C]`` faulted copies, threshold and seeds at run time;
  at a placement ``at = (col_off, global_cols)`` the plane is that column
  block of a ``[R, global_cols]`` plane and draws at its global counters
  (:func:`check_placement`). A burst process on any axis takes
  ``fault_inject_burst_tile_kernel`` (tiles of ``BURST_ROWS`` x
  ``burst_cols`` words in shared memory, only the live units' elements
  drawn); i.i.d., drift and correlated take ``fault_inject_batched_kernel``.
  One launch a call either way.
* K4 :func:`fault_inject_runs` replaces ``fault_inject_pallas``: one seed
  over a uint16 plane, or over the fp16 bit patterns of a float32 plane
  (the round trip to fp16 and back fused, in place or not), with the
  reference's Python-double threshold (:func:`static_threshold`), drawn in
  one launch from a device table of runs of rows: a whole leaf in its
  counter chunks, a block of a sharded leaf at its global counters
  (:func:`check_runs`), or one plane at one seed.

The library is built at first use by :class:`repro_torch.kernels.nvcc.
CudaLibrary`. Each wrapper takes CUDA tensors only (the CPU goes to
:mod:`.ref` through :mod:`.ops`), raises on what the kernel does not take,
and adds one to :data:`launch_counts` where it launches its kernel, and
nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.nvcc import CudaLibrary, check_rc, stream_of

CSRC = Path(__file__).resolve().parent / "csrc"

K3 = "fault_inject_batched"
K4 = "fault_inject"
launch_counts = {K3: 0, K4: 0}

PLANE_DTYPES = (torch.uint8, torch.uint16, torch.int32)
RUN_DTYPES = {torch.uint16: 2, torch.float32: 4}     # K4's planes: word bytes
# The kernel's fault-process codes: drift runs the i.i.d. code on a
# threshold the caller pre-scaled (ops.fault_inject_bits_batched).
MODEL_KINDS = {"iid": 0, "drift": 0, "burst": 1, "correlated": 2}
MODEL_AXES = {"row": 0, "col": 1, "bank": 2}


# The counter is a uint32 striding 32 per element, so streams repeat after
# 2^27 elements; beyond that, element pairs 2^27 apart would receive
# identical (correlated) faults. Refuse instead of silently biasing stats.
MAX_COUNTER_ELEMENTS = 2 ** 27


def check_counter_space(r: int, c: int) -> None:
    if r * c > MAX_COUNTER_ELEMENTS:
        raise ValueError(
            f"fault_inject counter space exhausted: {r}x{c} = {r * c} elements "
            f"> 2^27; split the leaf into chunks of <= {MAX_COUNTER_ELEMENTS} "
            f"elements (each with a distinct seed) to keep faults i.i.d.")


def static_threshold(ber: float) -> int:
    """The single-seed kernel's threshold, ``min(round(ber * 2^32),
    2^32 - 1)`` in Python doubles (round half to even). It can differ by one
    from :func:`ops.ber_to_threshold`'s float32 rule (4294967 against
    4294968 at BER 1e-3)."""
    return min(int(round(ber * 2 ** 32)), 2 ** 32 - 1)


def lanes_of(positions: Sequence[int], width: int) -> int:
    """Bit positions -> the kernel's lane mask; each must lie in the word."""
    lanes = 0
    for p in positions:
        if not 0 <= int(p) < width:
            raise ValueError(f"fault_inject: bit position {p} outside a "
                             f"{width}-bit word")
        lanes |= 1 << int(p)
    return lanes


def seed_words(seeds) -> np.ndarray:
    """Seeds (ints, a numpy array or a CPU tensor of uint32 values) ->
    uint32 [T]."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.detach().cpu().numpy()
    return (np.asarray(seeds, dtype=np.int64).reshape(-1)
            & 0xFFFFFFFF).astype(np.uint32)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.fault_inject_batched.argtypes = [vp, vp, vp] + [i] * 4 + [u] * 4 \
        + [i] * 5 + [vp]
    lib.fault_inject_batched.restype = i
    lib.fault_inject_runs.argtypes = [vp, vp] + [i] * 5 + [u] * 3 \
        + [i, vp, i, vp]
    lib.fault_inject_runs.restype = i


LIBRARY = CudaLibrary(CSRC / "fault_inject.cu", _bind)
load = LIBRARY.load
timed_build = LIBRARY.timed_build


def _launch(name: str, bits: torch.Tensor, seeds, threshold: int,
            positions: Sequence[int], m_thr: int, m_len: int,
            model_kind: str = "iid", model_axis: str = "row",
            col_div: int = 1, at=None) -> torch.Tensor:
    if bits.device.type != "cuda":
        raise ValueError(f"{name}: bits lie on {bits.device}; the kernel "
                         f"takes CUDA tensors (ops routes the CPU)")
    if bits.ndim != 2 or bits.dtype not in PLANE_DTYPES:
        raise ValueError(f"{name}: expected a 2-D uint8/uint16/int32 plane, "
                         f"got {bits.dtype} {tuple(bits.shape)}")
    if model_kind not in MODEL_KINDS or model_axis not in MODEL_AXES \
            or int(col_div) < 1:
        raise ValueError(f"{name}: fault process {model_kind!r} / "
                         f"{model_axis!r} / col_div {col_div} not taken")
    r, c = bits.shape
    col_off, gcols = check_placement(r, c, at)
    bits = bits.contiguous()
    if isinstance(seeds, torch.Tensor) and seeds.device == bits.device:
        seeds_dev = seeds.reshape(-1).to(torch.int32).contiguous()
    else:
        seeds_dev = torch.from_numpy(seed_words(seeds).view(np.int32)).to(
            bits.device)
    t = seeds_dev.numel()
    out = torch.empty((t, r, c), dtype=bits.dtype, device=bits.device)
    lanes = lanes_of(positions, bits.element_size() * 8)
    rc = load().fault_inject_batched(
        bits.data_ptr(), out.data_ptr(), seeds_dev.data_ptr(), t, r, c,
        bits.element_size(), lanes, int(threshold) & 0xFFFFFFFF,
        int(m_thr) & 0xFFFFFFFF, int(m_len) & 0xFFFFFFFF,
        MODEL_KINDS[model_kind], MODEL_AXES[model_axis], int(col_div),
        col_off, gcols, stream_of(bits))
    check_rc(rc, name)
    launch_counts[name] += 1
    return out


def fault_inject_batched(bits: torch.Tensor, seeds, threshold: int, *,
                         positions: Sequence[int], m_thr: int = 0,
                         m_len: int = 0, model_kind: str = "iid",
                         model_axis: str = "row",
                         col_div: int = 1, at=None) -> torch.Tensor:
    """K3: bits [R, C] on the card, seeds uint32 [T] -> [T, R, C] faulted
    copies (bit p of element e flips in trial t iff
    ``hash_u32((e*32 + p) ^ seeds[t]*0x9E3779B9) < thr(e, t)``). ``thr`` is
    ``threshold`` for ``model_kind`` iid or drift (drift comes pre-scaled);
    burst and correlated compute it per element in the kernel from the
    ``m_thr``/``m_len`` payload, the plane width C, ``col_div`` and the
    trial seed (``faultmodels.scale_elem_thresholds``). ``at = (col_off,
    global_cols)`` draws the plane as that column block of a ``[R,
    global_cols]`` plane: e is then ``r * global_cols + col_off + c`` and
    the process geometry the global plane's."""
    return _launch(K3, bits, seeds, threshold, positions, m_thr, m_len,
                   model_kind, model_axis, col_div, at)


def check_placement(r: int, c: int, at) -> tuple:
    """``(col_off, global_cols)`` of an ``[r, c]`` plane placed at ``at``
    (None: the whole plane, ``(0, c)``): the block must lie in its global
    plane, and the global plane in the counter space."""
    col_off, gcols = (0, c) if at is None else (int(v) for v in at)
    if col_off < 0 or col_off + c > gcols:
        raise ValueError(f"fault_inject at column {col_off}: a [{r}, {c}] "
                         f"block leaves its {gcols}-wide plane")
    check_counter_space(r, gcols)
    return col_off, gcols


def check_at(r: int, c: int, at) -> None:
    """A block [r, c] at ``at = (row_off, col_off, width)`` must lie in one
    counter chunk of a ``width``-word plane."""
    row_off, col_off, width = (int(v) for v in at)
    if min(row_off, col_off) < 0 or col_off + c > width or \
            (row_off + r - 1) * width + col_off + c > MAX_COUNTER_ELEMENTS:
        raise ValueError(f"fault_inject at {tuple(at)}: a [{r}, {c}] block "
                         f"leaves its {width}-wide counter chunk of "
                         f"{MAX_COUNTER_ELEMENTS} elements")


def check_runs(runs, rows: int, cols: int, col_off: int,
               width: int) -> None:
    """A run table ``((r0, chunk, row_off), ...)`` over a ``[rows, cols]``
    plane at column ``col_off`` of a ``width``-word counter plane: the
    first run at row 0, the others strictly after it and below ``rows``,
    each run's rows inside its counter chunk (:func:`check_at`); the plane
    below 2^32 elements (the kernel's element index)."""
    if rows * cols >= 2 ** 32:
        raise ValueError(f"fault_inject: a [{rows}, {cols}] plane holds "
                         f"2^32 elements or more; draw it in blocks")
    if not runs or runs[0][0] != 0:
        raise ValueError(f"fault_inject: runs {runs!r} do not start at row 0")
    ends = [r0 for r0, _, _ in runs[1:]] + [rows]
    for (r0, k, row_off), r1 in zip(runs, ends):
        if not r0 < r1 <= rows or not 0 <= k < 2 ** 31:
            raise ValueError(f"fault_inject: run {(r0, k, row_off)} of a "
                             f"{rows}-row plane ends at {r1}")
        check_at(r1 - r0, cols, (row_off, col_off, width))


def fault_inject_runs(x: torch.Tensor, table: torch.Tensor, *, seed: int,
                      ber: float, positions: Sequence[int], col_off: int,
                      width: int, fold: bool,
                      out: torch.Tensor) -> torch.Tensor:
    """K4: the contiguous plane ``x [R, C]`` on the card, uint16 bit
    patterns or float32 values (narrowed to fp16 bits as ``x.to(float16)``,
    flipped, widened as ``bitops.fp16_bits_to_f32``), written to ``out``
    (``x`` itself for in place), every element. ``table`` is the int32
    ``[n, 3]`` device copy of runs :func:`check_runs` accepted: run ``(r0,
    k, row_off)`` draws element (r, c) at counter ``(row_off + r - r0) *
    width + col_off + c`` from ``fold_seed(seed, k)`` (``fold``) or
    ``seed``, at ``positions`` with threshold ``min(round(ber * 2^32),
    2^32 - 1)`` in double precision. One launch."""
    if x.device.type != "cuda" or out.device != x.device \
            or table.device != x.device:
        raise ValueError(f"{K4}: x, out and the run table lie on "
                         f"{x.device}, {out.device}, {table.device}; the "
                         f"kernel takes CUDA tensors (ops routes the CPU)")
    if x.dtype not in RUN_DTYPES or out.dtype != x.dtype or x.ndim != 2 \
            or out.shape != x.shape or not x.is_contiguous() \
            or not out.is_contiguous():
        raise ValueError(f"{K4}: expected contiguous 2-D uint16 or float32 "
                         f"planes, got {x.dtype} {tuple(x.shape)} -> "
                         f"{out.dtype} {tuple(out.shape)}")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] != 3 \
            or not table.is_contiguous():
        raise ValueError(f"{K4}: expected an int32 [n, 3] run table, got "
                         f"{table.dtype} {tuple(table.shape)}")
    r, c = x.shape
    rc = load().fault_inject_runs(
        x.data_ptr(), out.data_ptr(), RUN_DTYPES[x.dtype], r, c,
        int(col_off), int(width), lanes_of(positions, 16),
        static_threshold(ber) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF,
        int(bool(fold)), table.data_ptr(), table.shape[0], stream_of(x))
    check_rc(rc, K4)
    launch_counts[K4] += 1
    return out
