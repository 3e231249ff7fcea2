"""Exponent alignment (port of ``repro/core/align.py``, paper §III-C).

Every block of ``N`` weights along the input channel is forced to share the
``index``-th largest biased exponent; positive and negative weights of a block
are min-max rescaled into ``[LL, UL]`` / ``[-UL, -LL]`` (Eq. 4) and rounded to
the fp16 grid.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import bitops
from repro_torch.core.bitops import FP16, FloatFormat


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    n_group: int = 8
    index: int = 2
    fmt: FloatFormat = FP16
    group_axis: int = 0


def _block_view(w: torch.Tensor, n: int, axis: int):
    """[K, J] -> [K//n, n, J], edge-padding K with the last row."""
    if axis != 0:
        w = torch.movedim(w, axis, 0)
    k = w.shape[0]
    rem = (-k) % n
    if rem:
        w = torch.cat([w, w[-1:].expand((rem,) + w.shape[1:])], 0)
    return w.reshape(-1, n, *w.shape[1:]), k


def _block_exponent_moved(w: torch.Tensor, cfg: AlignmentConfig) -> torch.Tensor:
    blocks, _ = _block_view(w, cfg.n_group, cfg.group_axis)
    exps = bitops.biased_exponent(blocks, cfg.fmt)
    order = torch.sort(exps, dim=1).values
    idx = min(max(cfg.n_group - cfg.index, 0), cfg.n_group - 1)
    return order[:, idx]


def block_exponent(w: torch.Tensor, cfg: AlignmentConfig) -> torch.Tensor:
    """E_index per block, block axis at ``cfg.group_axis``."""
    return torch.movedim(_block_exponent_moved(w, cfg), 0, cfg.group_axis)


def _rescale_signed(mag, mask, ll, ul):
    """Eq. 4 min-max rescale of the magnitudes selected by ``mask`` into
    [LL, UL]; degenerate classes map to the midpoint."""
    inf = torch.tensor(float("inf"), dtype=mag.dtype, device=mag.device)
    wmax = torch.where(mask, mag, -inf).amax(dim=1, keepdim=True)
    wmin = torch.where(mask, mag, inf).amin(dim=1, keepdim=True)
    span = wmax - wmin
    ok = torch.isfinite(span) & (span > 0)
    t = torch.where(ok, (mag - wmin) / torch.where(ok, span, torch.ones_like(span)),
                    torch.full_like(mag, 0.5))
    return t * (ul - ll) + ll


def align_matrix(w: torch.Tensor, cfg: AlignmentConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exponent-align one weight matrix -> (aligned weights, shared biased
    exponents [K/N-blocks, ...])."""
    orig_dtype = w.dtype
    blocks, k = _block_view(w, cfg.n_group, cfg.group_axis)
    e_moved = _block_exponent_moved(w, cfg)
    ll, ul = bitops.exponent_range(e_moved, cfg.fmt)
    ll = ll[:, None]
    ul = ul[:, None]

    mag = blocks.to(torch.float32).abs()
    pos = blocks >= 0
    y_pos = _rescale_signed(mag, pos, ll, ul)
    y_neg = _rescale_signed(mag, ~pos, ll, ul)
    y = torch.where(pos, y_pos, -y_neg)
    y = bitops.quantize_to_format(
        torch.minimum(torch.maximum(y.abs(), ll), ul), cfg.fmt) * torch.sign(y)

    y = y.reshape(-1, *y.shape[2:])[:k]
    if cfg.group_axis != 0:
        y = torch.movedim(y, 0, cfg.group_axis)
    return y.to(orig_dtype), torch.movedim(e_moved, 0, cfg.group_axis)
