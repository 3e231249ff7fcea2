"""Bind the hand-written CUDA fault-injection kernels of
``csrc/fault_inject.cu`` (port of ``repro/kernels/fault_inject/kernel.py``).

* K3 :func:`fault_inject_batched` replaces ``fault_inject_batched_pallas``:
  ``bits [R, C]`` (uint8, uint16 or uint32 held in int32) and trial seeds
  ``[T]`` -> ``[T, R, C]`` faulted copies, threshold and seeds at run time.
* K4 :func:`fault_inject` replaces ``fault_inject_pallas``: one seed over a
  uint16 plane, the same kernel launched at T = 1, with the reference's
  Python-double threshold (:func:`static_threshold`). With ``at`` it draws
  a block of a larger plane at its offsets (``fault_inject_at``): the
  ZeRO-3 step's Fig. 7 schedule on each rank's blocks.

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
        + [i, i, i, vp]
    lib.fault_inject_batched.restype = i
    lib.fault_inject_at.argtypes = [vp, vp, vp] + [i] * 3 + [u] * 2 \
        + [i] * 3 + [vp]
    lib.fault_inject_at.restype = i


LIBRARY = CudaLibrary(CSRC / "fault_inject.cu", _bind)
load = LIBRARY.load
timed_build = LIBRARY.timed_build


def _launch(name: str, bits: torch.Tensor, seeds, threshold: int,
            positions: Sequence[int], m_thr: int, m_len: int,
            model_kind: str = "iid", model_axis: str = "row",
            col_div: int = 1) -> torch.Tensor:
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
    check_counter_space(r, c)
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
        stream_of(bits))
    check_rc(rc, name)
    launch_counts[name] += 1
    return out


def fault_inject_batched(bits: torch.Tensor, seeds, threshold: int, *,
                         positions: Sequence[int], m_thr: int = 0,
                         m_len: int = 0, model_kind: str = "iid",
                         model_axis: str = "row",
                         col_div: int = 1) -> torch.Tensor:
    """K3: bits [R, C] on the card, seeds uint32 [T] -> [T, R, C] faulted
    copies (bit p of element e flips in trial t iff
    ``hash_u32((e*32 + p) ^ seeds[t]*0x9E3779B9) < thr(e, t)``). ``thr`` is
    ``threshold`` for ``model_kind`` iid or drift (drift comes pre-scaled);
    burst and correlated compute it per element in the kernel from the
    ``m_thr``/``m_len`` payload, the plane width C, ``col_div`` and the
    trial seed (``faultmodels.scale_elem_thresholds``)."""
    return _launch(K3, bits, seeds, threshold, positions, m_thr, m_len,
                   model_kind, model_axis, col_div)


def check_at(r: int, c: int, at) -> None:
    """A block [r, c] at ``at = (row_off, col_off, width)`` must lie in one
    counter chunk of a ``width``-word plane."""
    row_off, col_off, width = (int(v) for v in at)
    if min(row_off, col_off) < 0 or col_off + c > width or \
            (row_off + r - 1) * width + col_off + c > MAX_COUNTER_ELEMENTS:
        raise ValueError(f"fault_inject at {tuple(at)}: a [{r}, {c}] block "
                         f"leaves its {width}-wide counter chunk of "
                         f"{MAX_COUNTER_ELEMENTS} elements")


def _at_whole(r: int, c: int, at) -> bool:
    return at is None or tuple(int(v) for v in at) == (0, 0, c)


def fault_inject(bits: torch.Tensor, *, seed: int, ber: float,
                 positions: Sequence[int], at=None) -> torch.Tensor:
    """K4: uint16 bits [R, C] on the card -> bits with ``positions`` flipped
    at rate ``ber`` from one seed, threshold
    ``min(round(ber * 2^32), 2^32 - 1)`` in double precision. K4 has no
    fault-process slots (nor has the reference's). ``at = (row_off,
    col_off, width)`` draws the plane as the block at row ``row_off`` and
    column ``col_off`` of a counter chunk ``width`` words wide: element
    (r, c) at counter ``(row_off + r) * width + col_off + c``; ``(0, 0,
    C)`` is the plain draw."""
    if bits.dtype != torch.uint16:
        raise ValueError(f"{K4}: expected a uint16 plane, got {bits.dtype}")
    r, c = bits.shape if bits.ndim == 2 else (0, 0)
    if _at_whole(r, c, at):
        return _launch(K4, bits, [int(seed)], static_threshold(ber),
                       positions, 0, 0)[0]
    if bits.device.type != "cuda" or bits.ndim != 2:
        raise ValueError(f"{K4}: expected a 2-D plane on the card, got "
                         f"{tuple(bits.shape)} on {bits.device}")
    check_at(r, c, at)
    bits = bits.contiguous()
    seeds_dev = torch.from_numpy(seed_words([int(seed)]).view(np.int32)).to(
        bits.device)
    out = torch.empty_like(bits)
    row_off, col_off, width = (int(v) for v in at)
    rc = load().fault_inject_at(
        bits.data_ptr(), out.data_ptr(), seeds_dev.data_ptr(), 1, r, c,
        lanes_of(positions, 16), static_threshold(ber) & 0xFFFFFFFF,
        row_off, col_off, width, stream_of(bits))
    check_rc(rc, K4)
    launch_counts[K4] += 1
    return out
