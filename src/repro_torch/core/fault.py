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
counter-PRNG twin) is not ported. :func:`inject_block` draws one rank's
block of a sharded leaf (:class:`repro_torch.distributed.sharding.Layout`)
as exactly the flips of its region of :func:`inject`'s draw of the whole
leaf. Each is one K4 launch on the card (a leaf's counter chunks, or a
block's runs of rows in one chunk, as a table of runs), a float32 leaf's
round trip to fp16 bits fused into it.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import List, Mapping, Tuple

import numpy as np
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
    chunks). One K4 launch on the card, over every chunk."""
    if ber <= 0.0:
        return x
    cols = x.shape[-1]
    return _draw(seed, x, leaf_runs(x.numel() // cols, cols), 0, cols, ber,
                 field, fmt, None)


def draw_bits(bits: torch.Tensor, seed: int, ber: float,
              positions) -> torch.Tensor:
    """:func:`inject`'s draw on a uint16 plane [R, C]: one K4 launch."""
    r, c = bits.shape
    return fi_ops.fault_inject_runs(bits, leaf_runs(r, c), seed=seed, ber=ber,
                                    positions=positions)


def block_runs(layout) -> List[Tuple[int, int, int, int]]:
    """The draws of a block of a leaf: ``[(r0, r1, chunk, row_off)]`` over
    the rows of the block's plane ``reshape(-1, block[-1])``. Rows r0..r1
    lie at consecutive global rows of the leaf's plane ``reshape(-1,
    shape[-1])``, all in counter chunk ``chunk`` (:func:`counter_chunks`),
    the first at row ``row_off`` of it. A stacked ``[L, D, F]`` leaf split
    on D holds global rows ``l * D + d0 + d``: a run a layer at least."""
    shape, block, offs = layout.shape, layout.block, layout.offsets
    cols = shape[-1]
    fi_kernel.check_counter_space(1, cols)
    step = max(1, fi_kernel.MAX_COUNTER_ELEMENTS // cols)
    lead = block[:-1]
    idx = np.indices(lead, dtype=np.int64).reshape(len(lead), -1) \
        + np.asarray(offs[:-1], dtype=np.int64)[:, None]
    grow = np.ravel_multi_index(tuple(idx), shape[:-1]) if lead \
        else np.zeros(1, np.int64)
    chunk = grow // step
    cut = np.flatnonzero((np.diff(grow) != 1) | (np.diff(chunk) != 0)) + 1
    starts = np.concatenate([[0], cut]).astype(np.int64)
    ends = np.concatenate([cut, [grow.size]]).astype(np.int64)
    return [(int(a), int(b), int(chunk[a]), int(grow[a] - chunk[a] * step))
            for a, b in zip(starts, ends)]


def leaf_runs(rows: int, cols: int) -> tuple:
    """K4's run table ``((r0, chunk, row_off), ...)`` of a whole ``[rows,
    cols]`` plane: its :func:`counter_chunks`, each at row 0 of its chunk."""
    return tuple((r0, c, 0) for c, (r0, _) in enumerate(counter_chunks(rows,
                                                                      cols)))


def layout_runs(layout) -> tuple:
    """K4's run table of a block: its :func:`block_runs` as ``((r0, chunk,
    row_off), ...)``, worked out once a (shape, block, offsets, chunk
    size)."""
    return _layout_runs(tuple(layout.shape), tuple(layout.block),
                        tuple(layout.offsets),
                        fi_kernel.MAX_COUNTER_ELEMENTS)


@functools.lru_cache(maxsize=4096)
def _layout_runs(shape, block, offsets, max_elements) -> tuple:
    lay = types.SimpleNamespace(shape=shape, block=block, offsets=offsets)
    return tuple((r0, k, row_off) for r0, _, k, row_off in block_runs(lay))


def inject_block(seed: int, x: torch.Tensor, layout, ber: float,
                 field: str = "full", fmt: FloatFormat = FP16,
                 in_place: bool = False) -> torch.Tensor:
    """:func:`inject` of the whole leaf, restricted to the block ``x`` that
    ``layout`` places in it: every element draws at its global counter in
    its global chunk, in one K4 launch on the card over the block's runs
    (:func:`layout_runs`). ``in_place`` writes the faulty values into ``x``
    (contiguous), with no temporary at all for a float32 or fp16 block."""
    if ber <= 0.0:
        return x
    return _draw(seed, x, layout_runs(layout), layout.offsets[-1],
                 layout.shape[-1], ber, field, fmt, in_place)


def _draw(seed: int, x: torch.Tensor, runs: tuple, col_off: int, width: int,
          ber: float, field: str, fmt: FloatFormat,
          in_place) -> torch.Tensor:
    """K4 on the plane ``x.reshape(-1, x.shape[-1])`` over ``runs``."""
    bitops.get_format(fmt.name)
    if in_place and not x.is_contiguous():
        raise ValueError("inject_block in place: the block is not contiguous")
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    out = fi_ops.fault_inject_runs(
        flat, runs, seed=seed, ber=ber,
        positions=fmt.field_bit_positions(field), col_off=col_off,
        width=width, out=flat if in_place else None)
    return out.reshape(shape)


def draw_block_bits(bits: torch.Tensor, layout, seed: int, ber: float,
                    positions) -> torch.Tensor:
    """:func:`inject_block`'s draw on the block's uint16 plane
    ``reshape(-1, block[-1])``: one K4 launch."""
    return fi_ops.fault_inject_runs(bits, layout_runs(layout), seed=seed,
                                    ber=ber, positions=positions,
                                    col_off=layout.offsets[-1],
                                    width=layout.shape[-1])


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
