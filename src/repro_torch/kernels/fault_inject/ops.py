"""Counter-PRNG helpers shared by every injection path (port of
``hash_u32`` in ``repro/kernels/fault_inject/kernel.py`` and
``ber_to_threshold`` in ``repro/kernels/fault_inject/ops.py``).

The fault_inject kernels themselves wait (ROADMAP Queue 2, K3/K4).
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
_THR_SAT = np.float32(4294967040.0)


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


def ber_to_threshold(ber) -> int:
    """BER -> uint32 Bernoulli threshold (flip iff hash < threshold).

    ``round(ber * 2^32)`` in float32 with round-half-even, saturating to
    0xFFFFFFFF from 4294967040 up (float32 cannot represent 2^32 - 1)."""
    t = np.round(np.float32(ber) * np.float32(2.0 ** 32))
    if t >= _THR_SAT:
        return M32
    return int(t)
