"""SwiGLU channel MLP (port of ``repro/models/mlp.py``; GeLU and the RWKV
channel mix wait for ROADMAP Queue 1 item 12)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init


class MLP(nn.Module):
    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.mlp_type != "swiglu":
            raise NotImplementedError(
                f"mlp_type={cfg.mlp_type!r} waits (ROADMAP Queue 1 item 12)")
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        self.w_gate = nn.Parameter(dense_init((d, f), **kw))
        self.w_in = nn.Parameter(dense_init((d, f), **kw))
        self.w_out = nn.Parameter(dense_init((f, d), **kw))

    def forward(self, x):
        dt = x.dtype
        h = torch.nn.functional.silu(x @ self.w_gate.to(dt)) * (x @ self.w_in.to(dt))
        return h @ self.w_out.to(dt)
