"""Channel MLPs: SwiGLU and GeLU (port of ``repro/models/mlp.py``; the RWKV
channel mix waits for ROADMAP Queue 1 item 12.2)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init

# The weights each mlp_type holds, in the reference's init order.
MLP_LEAVES = {"swiglu": ("w_gate", "w_in", "w_out"),
              "gelu": ("w_in", "w_out")}


class MLP(nn.Module):
    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.mlp_type not in MLP_LEAVES:
            raise NotImplementedError(
                f"mlp_type={cfg.mlp_type!r} waits (ROADMAP Queue 1 item 12.2)")
        self.mlp_type = cfg.mlp_type
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        shapes = {"w_gate": (d, f), "w_in": (d, f), "w_out": (f, d)}
        for name in MLP_LEAVES[cfg.mlp_type]:
            setattr(self, name, nn.Parameter(dense_init(shapes[name], **kw)))

    def forward(self, x):
        dt = x.dtype
        if self.mlp_type == "swiglu":
            h = torch.nn.functional.silu(x @ self.w_gate.to(dt)) \
                * (x @ self.w_in.to(dt))
        else:
            # jax.nn.gelu defaults to the tanh form; torch's to the erf form
            h = torch.nn.functional.gelu(x @ self.w_in.to(dt),
                                         approximate="tanh")
        return h @ self.w_out.to(dt)
