"""Masked LM cross-entropy and the exponent-compression regularizer (port of
``repro/models/losses.py``). Every function here is differentiable: the
training step takes its gradient with ``torch.autograd``."""
from __future__ import annotations

from typing import Mapping

import torch

IGNORE = -100


def lm_loss_sums(logits: torch.Tensor, labels: torch.Tensor):
    """logits [B, S, V], labels [B, S] int (IGNORE masked) -> (the masked
    NLL sum, the hits, the unmasked tokens): :func:`lm_loss` before its
    division, for a caller that sums them over more rows first (a
    data-parallel step: an IGNORE-masked batch does not split evenly). A
    prediction counts as correct iff the label's logit equals the row max,
    as in the reference (a NaN row scores no hit)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int64)
    x = logits.to(torch.float32)
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    nll = lse - picked
    return (nll * mask).sum(), ((picked >= m) & mask).sum(), mask.sum()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor):
    """logits [B, S, V], labels [B, S] int (IGNORE masked) -> (loss,
    metrics): the mean masked NLL and the accuracy over the unmasked
    tokens (:func:`lm_loss_sums`)."""
    nll, hits, tokens = lm_loss_sums(logits, labels)
    denom = tokens.clamp(min=1)
    loss = nll / denom
    return loss, {"loss": loss, "accuracy": hits / denom, "tokens": denom}


# Co-design fine-tuning stage 1: alignment forces every N-block onto one
# shared exponent, so a weight far from its block's octave is crushed by the
# min-max rescale. The regularizer penalizes each block's log2-magnitude
# spread beyond a margin before alignment.


def exponent_spread_penalty(w: torch.Tensor, n_group: int = 8,
                            margin: float = 1.0,
                            eps: float = 1e-8) -> torch.Tensor:
    """Mean ReLU(log2-magnitude spread - margin) over the N-blocks of ``w``,
    grouped along axis ``ndim - 2`` (edge-padded) as
    :func:`repro_torch.core.align.align_matrix` groups them. ``amax`` /
    ``amin`` split the gradient evenly between ties, as the reference's
    reductions do."""
    from repro_torch.core.align import _block_view
    blocks, _ = _block_view(w.to(torch.float32), n_group, w.ndim - 2)
    loge = torch.log2(torch.maximum(blocks.abs(), blocks.new_tensor(eps)))
    spread = loge.amax(dim=1) - loge.amin(dim=1)
    return torch.relu(spread - margin).mean()


def exponent_compression_penalty(params: Mapping, policy,
                                 margin: float = 1.0, layouts=None,
                                 total=None) -> torch.Tensor:
    """Policy-weighted regularizer over a ``{path: tensor}`` tree: each leaf
    its rule deploys contributes :func:`exponent_spread_penalty` at the
    rule's ``n_group``; the mean over those leaves (0 when none).

    With ``layouts`` (``{path: Layout}``, a ZeRO-3 rank's blocks) a split
    leaf's spread penalty is its block's partial sum over the whole leaf's
    group count, plus ``total(layout, partial)`` (the partials summed over
    the ranks that hold the leaf's blocks) less the partial, detached: the
    whole leaf's value, and on a block the gradient of its own term."""
    from repro_torch.core.align import _block_view, is_alignable
    pens = []
    for path, leaf in params.items():
        rule = policy.rule_for(path)
        if not (rule.deploy and is_alignable(path, leaf)):
            continue
        lay = None if layouts is None else layouts[path]
        if lay is None or lay.whole:
            pens.append(exponent_spread_penalty(leaf, rule.n_group, margin))
            continue
        blocks, _ = _block_view(leaf.to(torch.float32), rule.n_group,
                                leaf.ndim - 2)
        loge = torch.log2(torch.maximum(blocks.abs(), blocks.new_tensor(1e-8)))
        excess = torch.relu(loge.amax(dim=1) - loge.amin(dim=1) - margin)
        g = len(lay.shape) - 2
        count = 1
        for i, n in enumerate(lay.shape):
            count *= -(-n // rule.n_group) if i == g else n
        part = excess.sum() / count
        pens.append(part + (total(lay, part.detach()) - part).detach())
    if not pens:
        return torch.zeros(())
    return torch.stack(pens).mean()
