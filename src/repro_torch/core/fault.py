"""Fault-injection vocabulary for FP weights (port of the parts of
``repro/core/fault.py`` that draw no ``jax.random`` stream).

Faults are i.i.d. Bernoulli(BER) per stored bit of one field of the fp16
representation (``sign`` / ``exponent`` / ``mantissa`` / ``full`` /
``exponent_sign``), the axes of the paper's Fig. 2. The port injects them
through the counter-PRNG kernels (:mod:`repro_torch.kernels.fault_inject`);
the reference's ``field_flip_mask`` / ``inject`` / ``inject_pytree`` draw
``jax.random.bernoulli`` streams and wait (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bitops import FP16, FloatFormat


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Configuration of the memory-error model.

    ber:     bit error rate (probability of a stored bit flipping per access).
    field:   which FP field faults land in (characterization axis).
    fmt:     stored number format (paper: fp16).
    mode:    'static' (inject once into deployed weights) or
             'dynamic' (fresh faults every weight access / train step).
    """

    ber: float = 0.0
    field: str = "full"
    fmt: FloatFormat = FP16
    mode: str = "static"

    def is_active(self) -> bool:
        return self.ber > 0.0


def _is_injectable(path: str, leaf) -> bool:
    """Weights (>=2-D float leaves) live in the CIM macro; vectors (norm
    scales, biases, decay parameters) live in protected register files."""
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 \
        and leaf.is_floating_point()


def expected_flips(n_values: int, ber: float, field: str,
                   fmt: FloatFormat = FP16) -> float:
    """E[#flipped bits] — used by tests and the characterization report."""
    return float(n_values) * len(fmt.field_bit_positions(field)) * ber
