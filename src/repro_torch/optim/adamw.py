"""AdamW with global-norm clipping and decoupled weight decay (port of
``repro/optim/adamw.py``), written out rather than taken from
``torch.optim.AdamW`` so that each operation follows the reference's order:
``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g²``,
``p - lr ((m/c1) / (sqrt(v/c2) + eps) + wd p)``, with the bias corrections
``c = 1 - b**step`` and the learning-rate schedule in float32.

Trees are ``{path: tensor}`` mappings; moments are fp32. The per-step scalars
(bias corrections, learning rate) are 0-dim float32 tensors on the
parameters' device, so every update divides by a tensor, never by a host
scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Mapping) -> dict:
    """Zero fp32 moments beside each leaf and a step count of 0 (int32)."""
    zeros = {p: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
             for p, w in params.items()}
    return {"m": zeros,
            "v": {p: torch.zeros_like(z) for p, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: Mapping) -> torch.Tensor:
    leaves = [x.to(torch.float32).square().sum() for x in tree.values()]
    return torch.stack(leaves).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: Mapping, max_norm: float):
    """Scale the gradients by ``min(1, max_norm / max(norm, 1e-12))`` -> (the
    same tensors, norm). In place, unlike the reference: the step owns its
    gradients, and a copy would hold a second gradient tree (5 GB at
    full-width olmo-1b)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(device)


@torch.no_grad()
def adamw_update(grads: Mapping, opt_state: Mapping, params: Mapping, lr,
                 cfg: AdamWConfig):
    """One AdamW step -> (new params, new opt state). ``lr`` is a 0-dim
    float32 tensor (:func:`make_lr_schedule`). Weight decay applies to
    leaves of two or more dimensions only."""
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    s = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), s)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), s)
    new_p, new_m, new_v = {}, {}, {}
    for path, g in grads.items():
        p = params[path]
        dev = p.device
        g32 = g.to(torch.float32)
        m = b1 * opt_state["m"][path] + (1 - b1) * g32
        v = b2 * opt_state["v"][path] + (1 - b2) * g32.square()
        update = (m / _f32(c1, dev)) / (torch.sqrt(v / _f32(c2, dev)) + cfg.eps)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p32 = p.to(torch.float32)
        new_p[path] = (p32 - _f32(lr, dev) * (update + wd * p32)).to(p.dtype)
        new_m[path], new_v[path] = m, v
        del update, g32
    return new_p, {"m": new_m, "v": new_v, "step": step}


def make_lr_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """step (int tensor) -> lr (0-dim float32): linear warmup, then cosine
    decay to a floor of 0.1 ``base_lr``, in float32 as the reference."""
    f32 = torch.float32

    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(f32)
        warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        floor = torch.tensor(base_lr * 0.1, dtype=f32)
        return torch.where(s < warmup, warm, torch.maximum(cos, floor))
    return lr
