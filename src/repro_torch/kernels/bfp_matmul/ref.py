"""Plain PyTorch version of the block-FP (One4N / BFP) matmul (port of
``repro/kernels/bfp_matmul/ref.py``).

It states what kernel K5 computes. The weight planes are a uint16
sign+mantissa plane (bit 15 sign, bits 0..9 the fp16 mantissa, implicit
leading 1) and one uint8 biased exponent per ``n_group`` rows; a weight is
``±(1 + m/1024) · 2^(e-15)``. The CPU tests run it in place of the kernel,
and ``chip_smoke.py`` holds the kernel against it on the card.

The scale is built exactly, as the fp32 bit pattern
``sign<<31 | (e+112)<<23 | m<<13``, for every ``e`` in 0..142. From
``e = 143`` the scale ``2^(e-15)`` overflows fp32: the reference gives
``±inf`` there, and so does this version (exponent field all ones, mantissa
cleared), never NaN or a field carried into the sign bit. The reference
computes ``jnp.exp2(e - 15)``, which XLA's CPU backend rounds a few ulp off
at ``e`` in {0, 2, 28, 30} and at most ``e`` in 32..142 (ROADMAP Queue 3);
there the two differ.

:func:`split_tf32` states the split of x that lets K5's tile variant run on
the TF32 tensor cores at fp32 accuracy; the CPU tests hold that recipe to
the reference with it, and nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops


def pack_bfp(w_aligned: torch.Tensor, n_group: int = 8):
    """Exponent-aligned fp16-grid weights [K, N] -> (man uint16, exp uint8).

    ``man`` packs the sign (bit 15) and the 10-bit mantissa; ``exp`` holds
    the shared biased exponent of each [n_group, :] block (the block max,
    exact for aligned weights)."""
    k, n = w_aligned.shape
    if k % n_group:
        raise ValueError(f"pack_bfp: K={k} is not a multiple of "
                         f"n_group={n_group}")
    s, e, m = bitops.split_fields(w_aligned, bitops.FP16)
    man = ((s << 15) | m).to(torch.int32).to(torch.uint16)
    exp = e.reshape(k // n_group, n_group, n).amax(dim=1).to(torch.uint8)
    return man, exp


def dequant_ref(man: torch.Tensor, exp: torch.Tensor, n_group: int = 8):
    """Inverse of :func:`pack_bfp`: f32 [K, N], ``±(1 + m/1024)·2^(e-15)``
    built in the fp32 exponent field: exact for ``e`` <= 142, ``±inf`` for
    ``e`` >= 143, where the scale overflows fp32."""
    b = man.to(torch.int64) & 0xFFFF
    e = exp.to(torch.int64).repeat_interleave(n_group, dim=0)
    inf = e >= 143
    field = torch.where(inf, 0xFF, e + 112)
    mant = torch.where(inf, 0, b & 0x3FF)
    bits = ((b >> 15) << 31) | (field << 23) | (mant << 13)
    return bits.to(torch.int32).view(torch.float32)


def bfp_matmul_ref(x: torch.Tensor, man: torch.Tensor, exp: torch.Tensor,
                   n_group: int = 8) -> torch.Tensor:
    """x [M, K] (f32 or bf16) @ dequant(man, exp) -> f32 [M, N]."""
    return x.to(torch.float32) @ dequant_ref(man, exp, n_group)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` as bit operations: fp32 rounded half away from
    zero to 10 mantissa bits (low 13 bits zero); inf and NaN pass as they
    are, a magnitude that rounds past the largest finite value gives inf."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = b & 0x7FFFFFFF
    rounded = (b & 0x80000000) | ((mag + 0x1000) & 0x7FFFE000)
    return torch.where(mag >= 0x7F800000, b, rounded).to(torch.int32) \
        .view(torch.float32)


def split_tf32(x: torch.Tensor):
    """K5's split of an fp32 ``x`` into two TF32 parts, ``(hi, lo)``:
    ``hi = cvt.rna.tf32.f32(x)``, ``lo`` the same rounding of ``x - hi``
    (exact in fp32), and ``lo = 0`` where that difference is NaN (an inf or
    NaN ``x``, which ``hi`` carries alone). For normal ``x``,
    ``|x - hi - lo| <= 2^-22 |x|``. Every K5 weight is exact in TF32, so
    ``hi @ W`` and ``lo @ W'`` are exact products (``W'`` is ``W`` with its
    ``±inf`` set to 0)."""
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    d = x - hi
    lo = torch.where(torch.isnan(d), torch.zeros_like(d), _tf32_rna(d))
    return hi, lo
