"""Fault injection into FP weights (port of ``repro/core/fault.py``).

Faults are i.i.d. Bernoulli(BER) per stored bit of one field of the fp16
representation (``sign`` / ``exponent`` / ``mantissa`` / ``full`` /
``exponent_sign``), the axes of the paper's Fig. 2. :func:`inject` and
:func:`inject_pytree` draw them through the counter-PRNG kernel K4
(:func:`repro_torch.kernels.fault_inject.ops.fault_inject_bits`; its
plain version for a CPU tensor), so they keep the reference's semantics but not
its stream: the reference draws ``jax.random.bernoulli`` here, and the
port's seeds follow the counter-PRNG contract instead (an explicit uint32
seed, folded per leaf and per counter chunk by :func:`cim.fold_seed`).
The reference's ``field_flip_mask`` (a ``jax.random`` mask with no
counter-PRNG twin) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import bitops
from repro_torch.core.bitops import FP16, FloatFormat
from repro_torch.core.cim import fold_seed
from repro_torch.kernels.fault_inject import kernel as fi_kernel
from repro_torch.kernels.fault_inject import ops as fi_ops


def counter_chunks(rows: int, cols: int) -> list:
    """Row ranges ``[(r0, r1)]`` of a ``[rows, cols]`` plane, each of at
    most 2^27 elements (the counter PRNG's space for one seed)."""
    fi_kernel.check_counter_space(1, cols)
    step = max(1, fi_kernel.MAX_COUNTER_ELEMENTS // cols)
    return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]


def inject(seed: int, x: torch.Tensor, ber: float, field: str = "full",
           fmt: FloatFormat = FP16) -> torch.Tensor:
    """Flip bits of ``x``'s fp16 representation at rate ``ber`` in ``field``.

    ``x`` (float32 storage of fp16-grid values, or fp16) is viewed as the
    plane ``reshape(-1, x.shape[-1])`` of fp16 bit patterns; the result
    comes back in ``x``'s dtype and shape. The plane is drawn in row chunks
    of at most 2^27 elements, since the counter PRNG addresses no more a
    seed: chunk ``c`` draws from ``fold_seed(seed, c)`` (a leaf of full-width
    olmo-1b's stacked MLP, [16, 2048, 8192] = 2^28 elements, takes two
    chunks). One K4 launch a chunk on the card."""
    if ber <= 0.0:
        return x
    shape = x.shape
    bits = bitops.to_bits(x.reshape(-1, shape[-1]), fmt)
    positions = tuple(int(p) for p in fmt.field_bit_positions(field))
    parts = [fi_ops.fault_inject_bits(bits[r0:r1], seed=fold_seed(seed, c),
                                      ber=ber, positions=positions)
             for c, (r0, r1) in enumerate(counter_chunks(*bits.shape))]
    # uint16 planes concatenate through their int16 views (CUDA has no
    # uint16 cat)
    out = parts[0] if len(parts) == 1 else torch.cat(
        [p.view(torch.int16) for p in parts]).view(torch.uint16)
    return bitops.bits_to_dtype(out, x.dtype, fmt).reshape(shape)


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


def inject_pytree(seed: int, params: Mapping, model: FaultModel) -> dict:
    """Injection over every injectable leaf of a ``{path: tensor}`` tree:
    leaf ``i`` (flatten order) draws from ``fold_seed(seed, i)``;
    other leaves pass through."""
    if not model.is_active():
        return dict(params)
    return {path: inject(fold_seed(seed, i), leaf, model.ber, model.field,
                         model.fmt) if _is_injectable(path, leaf) else leaf
            for i, (path, leaf) in enumerate(params.items())}


def expected_flips(n_values: int, ber: float, field: str,
                   fmt: FloatFormat = FP16) -> float:
    """E[#flipped bits] — used by tests and the characterization report."""
    return float(n_values) * len(fmt.field_bit_positions(field)) * ber
