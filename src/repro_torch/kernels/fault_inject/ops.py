"""Public wrappers of the fault-injection kernels (port of
``repro/kernels/fault_inject/ops.py``), plus the counter-PRNG helpers every
injection path shares (``hash_u32``, ``ber_to_threshold``).

The route follows the plane's device: a CUDA plane launches the
hand-written kernel — K3 (:func:`kernel.fault_inject_batched`) or K4
(:func:`kernel.fault_inject_runs`, one launch a call) — or raises; a CPU
plane runs the plain version of :mod:`.ref`, since no kernel runs on the
CPU. Nothing falls back.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core import faultmodels as fm
from repro_torch.core.bitops import FP16, FloatFormat
from repro_torch.kernels.fault_inject import kernel as kernel_lib
from repro_torch.kernels.fault_inject import ref
from repro_torch.kernels.fault_inject.ref import hash_u32  # noqa: F401

M32 = 0xFFFFFFFF
_THR_SAT = np.float32(4294967040.0)


def ber_to_threshold(ber) -> int:
    """BER -> uint32 Bernoulli threshold (flip iff hash < threshold).

    ``round(ber * 2^32)`` in float32 with round-half-even, saturating to
    0xFFFFFFFF from 4294967040 up (float32 cannot represent 2^32 - 1)."""
    t = np.round(np.float32(ber) * np.float32(2.0 ** 32))
    if t >= _THR_SAT:
        return M32
    return int(t)


@functools.lru_cache(maxsize=4096)
def run_table(runs: tuple, device: torch.device) -> torch.Tensor:
    """The int32 ``[n, 3]`` device copy of a run table, made once: a
    leaf's or a block's runs are the same at every step."""
    return torch.tensor(runs, dtype=torch.int32).reshape(-1, 3).to(device)


@functools.lru_cache(maxsize=4096)
def _checked(runs: tuple, rows: int, cols: int, col_off: int, width: int,
             max_elements: int) -> None:
    kernel_lib.check_runs(runs, rows, cols, col_off, width)


def fault_inject_runs(x: torch.Tensor, runs: tuple, *, seed: int,
                      ber: float, positions: Sequence[int], col_off: int = 0,
                      width: int = None, fold: bool = True,
                      out: torch.Tensor = None) -> torch.Tensor:
    """K4 over a run table ``((r0, chunk, row_off), ...)`` (see
    :func:`kernel.check_runs`): the plane ``x [R, C]`` drawn in one launch
    on the card, or by the plain version on the CPU. ``x`` holds uint16 bit
    patterns or fp16-grid values: float32 takes the fused round trip,
    float16 its uint16 view, another float type its fp16 bits
    (``bitops.to_bits``) and back. The result goes to ``out`` (``x`` for in
    place) or a new plane of ``x``'s dtype."""
    r, c = x.shape
    width = c if width is None else int(width)
    runs = tuple(tuple(int(v) for v in run) for run in runs)
    _checked(runs, r, c, int(col_off), width, kernel_lib.MAX_COUNTER_ELEMENTS)
    if x.dtype == torch.float16:
        got = fault_inject_runs(
            x.view(torch.uint16), runs, seed=seed, ber=ber,
            positions=positions, col_off=col_off, width=width, fold=fold,
            out=None if out is None else out.view(torch.uint16))
        return got.view(torch.float16)
    if x.dtype not in kernel_lib.RUN_DTYPES:
        if not x.is_floating_point():
            raise ValueError(f"fault_inject: a {x.dtype} plane is neither "
                             f"uint16 bits nor fp16-grid values")
        got = fault_inject_runs(bitops.to_bits(x), runs, seed=seed, ber=ber,
                                positions=positions, col_off=col_off,
                                width=width, fold=fold)
        got = bitops.bits_to_dtype(got, x.dtype)
        return got if out is None else out.copy_(got)
    kw = dict(seed=seed, ber=ber, positions=tuple(int(p) for p in positions),
              col_off=int(col_off), width=width, fold=fold)
    if x.device.type == "cuda":
        if out is None:
            x = x.contiguous()
            out = torch.empty_like(x)
        return kernel_lib.fault_inject_runs(x, run_table(runs, x.device),
                                            out=out, **kw)
    return ref.fault_inject_runs_ref(x, runs, out=out, **kw)


def fault_inject_bits(bits: torch.Tensor, *, seed: int, ber: float,
                      positions: Sequence[int], at=None) -> torch.Tensor:
    """Single-seed injection of a uint16 plane [R, C] (K4 on the card, a
    one-run table); ``at = (row_off, col_off, width)`` draws it as that
    block of a wider counter chunk: element (r, c) at counter ``(row_off +
    r) * width + col_off + c``; ``(0, 0, C)`` is the plain draw."""
    r, c = bits.shape
    kernel_lib.check_counter_space(r, c)
    row_off, col_off, width = (0, 0, c) if at is None \
        else (int(v) for v in at)
    return fault_inject_runs(bits, ((0, 0, row_off),), seed=seed, ber=ber,
                             positions=positions, col_off=col_off,
                             width=width, fold=False)


def placement(at, c: int, plane: str = None):
    """``(col_off, global_cols)`` of a 2-D plane ``c`` words wide from
    ``at``: None (the whole plane), a ``(col_off, global_cols)`` pair, or a
    column shard's ``cim.ShardInfo`` with the ``plane`` it cut (``'man'``,
    ``'cw'``, ``'exp'``, ``'sign'``; a 4-D plane's global width is its
    flattened row). A shard that holds the whole image is the whole plane;
    a K shard raises (a sweep places ``dim='j'`` only)."""
    if at is None or isinstance(at, tuple):
        return at
    if not at.sharded:
        return None
    if at.dim != "j":
        raise NotImplementedError(
            "fault_inject_bits_batched: a K-sharded plane (dim='k') has no "
            "column placement; the sweep places dim='j'")
    gshape = at.plane_shape(plane)
    gcols = int(np.prod(gshape[1:]))
    if gcols != c * at.n_shards:
        raise ValueError(f"fault_inject_bits_batched: a {c}-word block is "
                         f"not 1/{at.n_shards} of plane {plane!r} "
                         f"{tuple(gshape)}")
    return at.index * c, gcols


def fault_inject_bits_batched(bits: torch.Tensor, seeds, threshold, *,
                              positions: Sequence[int], model=None,
                              col_div: int = 1, at=None,
                              plane: str = None) -> torch.Tensor:
    """Trial-batched injection: bits [R, C] -> [T, R, C] (K3 on the card).

    ``seeds`` is uint32 [T], ``threshold`` the uint32 of
    :func:`ber_to_threshold`. ``model`` is a fault process (or its grammar
    string): burst and correlated scale the threshold per element inside the
    kernel, from its ``m_thr``/``m_len`` payload and the trial's seed;
    drift pre-scales ``threshold`` by its static tick here; i.i.d. (and
    ``None``) keep it. ``col_div`` is the plane's macro-column unit in words
    (``S*W`` for a flattened codeword plane ``[B, G*S*W]``). ``at`` places
    the plane as a column block of a wider plane (:func:`placement`: a
    ``(col_off, global_cols)`` pair, or a ``ShardInfo`` with its ``plane``
    name): each element draws at its global counter, under the global
    plane's process geometry, and the counter space checked is the global
    plane's."""
    model = fm.parse_fault_model(model)
    threshold = fm.compiled_threshold(model, threshold)
    m_thr, m_len = fm.model_scalars(model)
    kind = model.kind if model is not None else "iid"
    axis = model.axis if model is not None else "row"
    r, c = bits.shape
    at = placement(at, c, plane)
    kernel_lib.check_placement(r, c, at)
    kw = dict(positions=tuple(positions), m_thr=m_thr, m_len=m_len,
              model_kind=kind, model_axis=axis, col_div=col_div, at=at)
    if bits.device.type == "cuda":
        return kernel_lib.fault_inject_batched(bits, seeds, threshold, **kw)
    return ref.fault_inject_batched_ref(bits, seeds, threshold, **kw)


def fault_inject_fp16(w: torch.Tensor, *, seed: int, ber: float,
                      field: str = "full",
                      fmt: FloatFormat = FP16) -> torch.Tensor:
    """Field-targeted injection on an fp16-grid float tensor (K4 on the
    card: one launch, a float32 tensor's round trip to fp16 bits fused); the
    result has ``w``'s dtype and shape."""
    bitops.get_format(fmt.name)
    shape = w.shape
    plane = w.reshape(-1, shape[-1]).contiguous()
    kernel_lib.check_counter_space(*plane.shape)
    out = fault_inject_runs(plane, ((0, 0, 0),), seed=seed, ber=ber,
                            positions=fmt.field_bit_positions(field),
                            fold=False)
    return out.reshape(shape)
