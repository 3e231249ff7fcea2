"""Public wrappers of the fault-injection kernels (port of
``repro/kernels/fault_inject/ops.py``), plus the counter-PRNG helpers every
injection path shares (``hash_u32``, ``ber_to_threshold``).

The route follows the plane's device: a CUDA plane launches the
hand-written kernel — K3 (:func:`kernel.fault_inject_batched`) or K4
(:func:`kernel.fault_inject`) — or raises; a CPU plane runs the plain
version of :mod:`.ref`, since no kernel runs on the CPU. Nothing falls back.
"""
from __future__ import annotations

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


def fault_inject_bits(bits: torch.Tensor, *, seed: int, ber: float,
                      positions: Sequence[int], at=None) -> torch.Tensor:
    """Single-seed injection of a uint16 plane [R, C] (K4 on the card);
    ``at = (row_off, col_off, width)`` draws it as that block of a wider
    counter chunk (:func:`kernel.fault_inject`)."""
    r, c = bits.shape
    kernel_lib.check_counter_space(r, c)
    if at is not None:
        kernel_lib.check_at(r, c, at)
    if bits.device.type == "cuda":
        return kernel_lib.fault_inject(bits, seed=seed, ber=ber,
                                       positions=tuple(positions), at=at)
    return ref.fault_inject_ref(bits, seed=seed, ber=ber,
                                positions=tuple(positions), at=at)


def fault_inject_bits_batched(bits: torch.Tensor, seeds, threshold, *,
                              positions: Sequence[int], model=None,
                              col_div: int = 1) -> torch.Tensor:
    """Trial-batched injection: bits [R, C] -> [T, R, C] (K3 on the card).

    ``seeds`` is uint32 [T], ``threshold`` the uint32 of
    :func:`ber_to_threshold`. ``model`` is a fault process (or its grammar
    string): burst and correlated scale the threshold per element inside the
    kernel, from its ``m_thr``/``m_len`` payload and the trial's seed;
    drift pre-scales ``threshold`` by its static tick here; i.i.d. (and
    ``None``) keep it. ``col_div`` is the plane's macro-column unit in words
    (``S*W`` for a flattened codeword plane ``[B, G*S*W]``)."""
    model = fm.parse_fault_model(model)
    threshold = fm.compiled_threshold(model, threshold)
    m_thr, m_len = fm.model_scalars(model)
    kind = model.kind if model is not None else "iid"
    axis = model.axis if model is not None else "row"
    r, c = bits.shape
    kernel_lib.check_counter_space(r, c)
    if bits.device.type == "cuda":
        return kernel_lib.fault_inject_batched(
            bits, seeds, threshold, positions=tuple(positions), m_thr=m_thr,
            m_len=m_len, model_kind=kind, model_axis=axis, col_div=col_div)
    return ref.fault_inject_batched_ref(
        bits, seeds, threshold, positions=tuple(positions), m_thr=m_thr,
        m_len=m_len, model_kind=kind, model_axis=axis, col_div=col_div)


def fault_inject_fp16(w: torch.Tensor, *, seed: int, ber: float,
                      field: str = "full",
                      fmt: FloatFormat = FP16) -> torch.Tensor:
    """Field-targeted injection on an fp16-grid float tensor (kernel path);
    the result has ``w``'s dtype and shape."""
    shape = w.shape
    bits = bitops.to_bits(w.reshape(-1, shape[-1]), fmt)
    positions = tuple(int(p) for p in fmt.field_bit_positions(field))
    out = fault_inject_bits(bits, seed=seed, ber=ber, positions=positions)
    return bitops.bits_to_dtype(out, w.dtype, fmt).reshape(shape)
