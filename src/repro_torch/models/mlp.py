"""Channel MLPs: SwiGLU, GeLU and the RWKV channel mix (port of
``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.models.common import Leaves, dense_init

# The leaves each mlp_type holds, in the reference's init order.
MLP_LEAVES = {"swiglu": ("w_gate", "w_in", "w_out"),
              "gelu": ("w_in", "w_out"),
              "rwkv_cmix": ("w_r", "w_in", "w_out", "mix_k", "mix_r")}


class MLP(Leaves):
    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.mlp_type not in MLP_LEAVES:
            raise ValueError(f"mlp_type {cfg.mlp_type!r}")
        self.mlp_type = cfg.mlp_type
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        shapes = {"w_gate": (d, f), "w_in": (d, f), "w_out": (f, d),
                  "w_r": (d, d)}
        for name in MLP_LEAVES[cfg.mlp_type]:
            if name.startswith("mix_"):     # the channel mix's lerp, 0.5
                w = torch.full((d,), 0.5, dtype=cfg.pdtype(), device=device)
            else:
                w = dense_init(shapes[name], **kw)
            setattr(self, name, nn.Parameter(w))

    def forward(self, x, x_shifted=None, over: Mapping = {}):
        """x [..., D] -> [..., D]; ``rwkv_cmix`` also takes the token-shifted
        stream ``x_shifted`` (each row's previous token)."""
        dt = x.dtype
        W = lambda name: self.w(name, over).to(dt)      # noqa: E731
        if self.mlp_type == "swiglu":
            h = torch.nn.functional.silu(x @ W("w_gate")) * (x @ W("w_in"))
        elif self.mlp_type == "gelu":
            # jax.nn.gelu defaults to the tanh form; torch's to the erf form
            h = torch.nn.functional.gelu(x @ W("w_in"), approximate="tanh")
        else:
            if x_shifted is None:
                raise ValueError("the rwkv channel mix needs the shifted "
                                 "stream")
            mk, mr = W("mix_k"), W("mix_r")
            xk = x * mk + x_shifted * (1 - mk)
            xr = x * mr + x_shifted * (1 - mr)
            h = torch.relu(xk @ W("w_in")).square()
            return torch.sigmoid(xr @ W("w_r")) * (h @ W("w_out"))
        return h @ W("w_out")
