"""Masked LM cross-entropy and accuracy (port of ``lm_loss`` in
``repro/models/losses.py``; inference only)."""
from __future__ import annotations

import torch

IGNORE = -100


def lm_loss(logits: torch.Tensor, labels: torch.Tensor):
    """logits [B, S, V], labels [B, S] int (IGNORE masked) -> (loss,
    metrics). A prediction counts as correct iff the label's logit equals
    the row max, as in the reference (a NaN row scores no hit)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int64)
    x = logits.to(torch.float32)
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    nll = lse - picked
    denom = mask.sum().clamp(min=1)
    loss = (nll * mask).sum() / denom
    acc = ((picked >= m) & mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
