"""Exponent alignment (port of ``repro/core/align.py``, paper §III-C).

Every block of ``N`` weights along the input channel is forced to share the
``index``-th largest biased exponent; positive and negative weights of a block
are min-max rescaled into ``[LL, UL]`` / ``[-UL, -LL]`` (Eq. 4) and rounded to
the fp16 grid.

Fine-tuning then freezes exponent and sign and updates only mantissas, as a
projection (:func:`project_to_block_exponent`) after each optimizer step.
The ``*_pytree`` functions work over ``{path: tensor}`` trees in the
reference's flatten order (:mod:`repro_torch.core.tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

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


def project_to_block_exponent(w: torch.Tensor, e_shared: torch.Tensor,
                              sign0: Optional[torch.Tensor],
                              cfg: AlignmentConfig) -> torch.Tensor:
    """Project weights back onto the frozen (exponent, sign) manifold, as
    after every optimizer update of the fine-tune: magnitudes clamped into
    the block's [LL, UL] and rounded to the fp16 grid, signs frozen to
    ``sign0`` (``None`` lets them float). ``e_shared`` has the block axis at
    ``cfg.group_axis``, as :func:`block_exponent` returns it. The result is
    contiguous."""
    orig_dtype = w.dtype
    blocks, k = _block_view(w, cfg.n_group, cfg.group_axis)
    e_moved = torch.movedim(e_shared, cfg.group_axis, 0)
    ll, ul = bitops.exponent_range(e_moved, cfg.fmt)
    mag = torch.clamp(blocks.to(torch.float32).abs(), ll[:, None], ul[:, None])
    if sign0 is not None:
        sblocks, _ = _block_view(sign0, cfg.n_group, cfg.group_axis)
        sgn = torch.where(sblocks > 0, 1.0, -1.0)
    else:
        sgn = torch.where(blocks >= 0, 1.0, -1.0)
    del blocks
    y = bitops.quantize_to_format(mag, cfg.fmt) * sgn
    y = y.reshape(-1, *y.shape[2:])[:k]
    if cfg.group_axis != 0:
        y = torch.movedim(y, 0, cfg.group_axis)
    return y.to(orig_dtype).contiguous()


def is_alignable(path: str, leaf) -> bool:
    """Leaves the technique applies to: >=2-D float weights."""
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and \
        leaf.is_floating_point()


def _leaf_group_axis(leaf: torch.Tensor) -> int:
    """Input-channel axis: ``ndim - 2`` of [in, out] matrices, layer-stacked
    [L, in, out] blocks included."""
    return leaf.ndim - 2


def _leaf_cfg(cfg: AlignmentConfig, leaf: torch.Tensor) -> AlignmentConfig:
    return dataclasses.replace(cfg, group_axis=_leaf_group_axis(leaf))


def _align_tree(params: Mapping, cfg_of, predicate):
    """``cfg_of(path)`` -> the leaf's AlignmentConfig, or None to pass it
    through. One leaf at a time, so only one leaf's temporaries are live."""
    out_w, out_e = {}, {}
    for path, leaf in params.items():
        cfg = cfg_of(path) if predicate(path, leaf) else None
        if cfg is None:
            out_w[path], out_e[path] = leaf, None
        else:
            out_w[path], out_e[path] = align_matrix(leaf, _leaf_cfg(cfg, leaf))
    return out_w, out_e


def _project_tree(params: Mapping, exps: Mapping, signs: Mapping, cfg_of,
                  predicate) -> dict:
    out = {}
    for path, w in params.items():
        e = exps.get(path)
        if e is None or not predicate(path, w):
            out[path] = w
        else:
            out[path] = project_to_block_exponent(
                w, e, signs.get(path), _leaf_cfg(cfg_of(path), w))
    return out


@torch.no_grad()
def align_pytree(params: Mapping, cfg: AlignmentConfig,
                 predicate=is_alignable):
    """Align every eligible leaf of a ``{path: tensor}`` tree. Returns
    (aligned tree, exponents tree with ``None`` on the leaves left as they
    are)."""
    return _align_tree(params, lambda path: cfg, predicate)


@torch.no_grad()
def align_pytree_policy(params: Mapping, policy, predicate=is_alignable):
    """Per-rule alignment: each leaf with its policy rule's (n_group, index,
    fmt), or passed through when the rule says ``deploy=False``. Returns
    (aligned tree, exponents tree with ``None`` on passthrough leaves), the
    manifold a fine-tuned model is later packed from."""
    def cfg_of(path):
        rule = policy.rule_for(path)
        return rule.align_cfg if rule.deploy else None
    return _align_tree(params, cfg_of, predicate)


@torch.no_grad()
def project_pytree_policy(params: Mapping, exps: Mapping, signs: Mapping,
                          policy, predicate=is_alignable) -> dict:
    """Per-rule frozen-(exponent, sign) projection, the multi-rule
    counterpart of :func:`project_pytree`."""
    return _project_tree(params, exps, signs,
                         lambda path: policy.rule_for(path).align_cfg,
                         predicate)


@torch.no_grad()
def project_pytree(params: Mapping, exps: Mapping, signs: Mapping,
                   cfg: AlignmentConfig, predicate=is_alignable) -> dict:
    """Post-update projection over a ``{path: tensor}`` tree (see
    :func:`project_to_block_exponent`); leaves whose exponent is ``None``
    pass through."""
    return _project_tree(params, exps, signs, lambda path: cfg, predicate)
