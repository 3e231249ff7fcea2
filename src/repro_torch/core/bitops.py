"""Bit-level views of IEEE fp16 (port of ``repro/core/bitops.py``).

Only fp16, the paper's format, is ported; the bf16/fp32/fp8 formats wait
(ROADMAP Queue 1 item 1). Integer fields come back as ``int64`` tensors so
that callers can shift and mask them on any device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """Static description of an IEEE-like binary float format."""

    name: str
    total_bits: int
    exp_bits: int
    man_bits: int
    float_dtype: object
    uint_dtype: object

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def sign_shift(self) -> int:
        return self.total_bits - 1

    @property
    def exp_shift(self) -> int:
        return self.man_bits

    @property
    def exp_mask(self) -> int:
        return ((1 << self.exp_bits) - 1) << self.man_bits

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def sign_mask(self) -> int:
        return 1 << self.sign_shift

    @property
    def max_mantissa_value(self) -> float:
        """M_max in the paper's Fig. 5: largest 1.M value, 2 - 2^-man_bits."""
        return 2.0 - 2.0 ** (-self.man_bits)

    def field_bit_positions(self, field: str) -> np.ndarray:
        """Bit indices (LSB=0) belonging to ``field``."""
        if field == "sign":
            return np.array([self.sign_shift], dtype=np.int32)
        if field == "exponent":
            return np.arange(self.man_bits, self.man_bits + self.exp_bits,
                             dtype=np.int32)
        if field == "mantissa":
            return np.arange(0, self.man_bits, dtype=np.int32)
        if field == "full":
            return np.arange(0, self.total_bits, dtype=np.int32)
        if field == "exponent_sign":  # the One4N-protected payload
            return np.arange(self.man_bits, self.total_bits, dtype=np.int32)
        raise ValueError(f"unknown field {field!r}")


FP16 = FloatFormat("fp16", 16, 5, 10, torch.float16, torch.uint16)

# The reference's format vocabulary; only fp16 is ported (see FORMATS).
FORMAT_NAMES = ("fp16", "bf16", "fp32", "fp8_e4m3", "fp8_e5m2")
FORMATS = {"fp16": FP16}


def get_format(name: str) -> FloatFormat:
    if name not in FORMATS:
        raise NotImplementedError(
            f"format {name!r} is not ported yet (ROADMAP Queue 1 item 1: "
            f"this slice ports fp16 only)")
    return FORMATS[name]


def _check_fp16(fmt: FloatFormat) -> None:
    if fmt.name != "fp16":
        raise NotImplementedError(f"format {fmt.name!r} is not ported yet")


def to_bits(x: torch.Tensor, fmt: FloatFormat = FP16) -> torch.Tensor:
    """Float tensor -> uint16 bit pattern (rounded to fp16 first, RNE)."""
    _check_fp16(fmt)
    return x.to(torch.float16).view(torch.uint16)


def from_bits(bits: torch.Tensor, fmt: FloatFormat = FP16) -> torch.Tensor:
    """uint16 bit pattern -> float16 tensor."""
    _check_fp16(fmt)
    return (bits.to(torch.int64) & 0xFFFF).to(torch.uint16).view(torch.float16)


def split_fields(x: torch.Tensor, fmt: FloatFormat = FP16):
    """Return (sign, biased_exponent, mantissa) as int64 tensors."""
    b = to_bits(x, fmt).to(torch.int64) & 0xFFFF
    sign = (b >> fmt.sign_shift) & 1
    exp = (b >> fmt.exp_shift) & ((1 << fmt.exp_bits) - 1)
    man = b & fmt.man_mask
    return sign, exp, man


def combine_bits(sign, exp, man, fmt: FloatFormat = FP16) -> torch.Tensor:
    """(sign, biased exponent, mantissa) -> int64 fp16 bit pattern."""
    return ((sign.to(torch.int64) & 1) << fmt.sign_shift) \
        | ((exp.to(torch.int64) & ((1 << fmt.exp_bits) - 1)) << fmt.exp_shift) \
        | (man.to(torch.int64) & fmt.man_mask)


def combine_fields(sign, exp, man, fmt: FloatFormat = FP16) -> torch.Tensor:
    """Assemble fp16 values from integer (sign, biased_exponent, mantissa)."""
    return from_bits(combine_bits(sign, exp, man, fmt), fmt)


def fp16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """fp16 bit patterns (int64) -> float32, bit for bit as the reference's
    ``astype(float32)`` widens them: NaN payloads shift up by 13 bits with the
    quiet bit set. torch's own half->float conversion canonicalises NaNs on
    the CPU, so the widening is done on the integer fields here."""
    b = bits.to(torch.int64) & 0xFFFF
    sign = (b >> 15) << 31
    e = (b >> 10) & 0x1F
    m = b & 0x3FF
    normal = sign | ((e + 112) << 23) | (m << 13)
    special = sign | 0x7F800000 | torch.where(m != 0, 0x400000 | (m << 13),
                                              torch.zeros_like(m))
    # zero and subnormals: m * 2^-24 is exact in float32
    sub = (m.to(torch.float32) * 2.0 ** -24).view(torch.int32).to(torch.int64)
    sub = sign | (sub & 0x7FFFFFFF)
    out = torch.where(e == 0, sub, torch.where(e == 0x1F, special, normal))
    return out.to(torch.int32).view(torch.float32)


def bits_to_dtype(bits: torch.Tensor, dtype: torch.dtype,
                  fmt: FloatFormat = FP16) -> torch.Tensor:
    """fp16 bit patterns -> values of ``dtype``, as the reference's
    ``asarray(from_bits(bits), dtype)``: float32 widens bit for bit."""
    _check_fp16(fmt)
    if dtype == torch.float32:
        return fp16_bits_to_f32(bits)
    return from_bits(bits, fmt).to(dtype)


def fields_to_f32(sign, exp, man, fmt: FloatFormat = FP16) -> torch.Tensor:
    """Fields -> float32 (the reference's ``asarray(combine_fields(..),
    float32)``)."""
    _check_fp16(fmt)
    return fp16_bits_to_f32(combine_bits(sign, exp, man, fmt))


def biased_exponent(x: torch.Tensor, fmt: FloatFormat = FP16) -> torch.Tensor:
    """Biased exponent field of each value (0 for zeros/subnormals)."""
    return split_fields(x, fmt)[1]


def pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for integer ``e`` in the normal range, built in
    the exponent field."""
    return ((e.to(torch.int64) + 127) << 23).to(torch.int32).view(torch.float32)


def exponent_range(biased_exp: torch.Tensor, fmt: FloatFormat = FP16):
    """(LL, UL) representable with a fixed biased exponent (paper Fig. 5).

    The scale is an exact power of two. The reference computes it with
    ``jnp.exp2``, which XLA's CPU backend rounds a few ulp off for exponents
    -15, -13, 13 and 15 (ROADMAP Queue 3)."""
    scale = pow2_f32(biased_exp.to(torch.int64) - fmt.bias)
    return scale, scale * fmt.max_mantissa_value


def quantize_to_format(x: torch.Tensor, fmt: FloatFormat = FP16) -> torch.Tensor:
    """Round values to the format grid, returned in float32."""
    _check_fp16(fmt)
    return x.to(torch.float16).to(torch.float32)
