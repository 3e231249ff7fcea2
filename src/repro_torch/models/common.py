"""Shared layer primitives (port of ``repro/models/common.py``)."""
from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn


class Leaves(nn.Module):
    """A module whose compute methods take ``over``, a ``{name: tensor}``
    mapping of leaves that replace its own parameters for one call: how a
    serving dict's decoded leaves (the hbm path) and a reference-layout tree
    (:func:`repro_torch.models.lm.forward`) reach the layer without copying
    into it."""

    def w(self, name: str, over: Mapping = {}) -> torch.Tensor:
        return over[name] if name in over else getattr(self, name)


def dense_init(shape, *, generator=None, device=None, dtype=torch.float32):
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in), cut at 2 std)."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w / math.sqrt(fan_in)).to(dtype)


def embed_init(shape, *, generator=None, device=None, dtype=torch.float32):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * (1.0 + scale.to(torch.float32))
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def nonparametric_ln(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm: no learnable scale/bias."""
    return layernorm(x, None, None, eps)


def apply_norm(norm_type: str, params, x):
    if norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if norm_type == "nonparametric_ln":
        return nonparametric_ln(x)
    raise ValueError(norm_type)


# The parameters each norm_type holds, in flatten order.
NORM_LEAVES = {"rmsnorm": ("scale",), "layernorm": ("bias", "scale"),
               "nonparametric_ln": ()}

# The leaves the models initialise to a constant (the norms, RWKV's lerps,
# group-norm scale, bonus and decay base, RG-LRU's gates and conv bias), each
# with the (scale, mean) of the normal draw that parity tests and the card's
# smoke run put in their place, so that every leaf carries a signal; the
# decay base spread over [-9, 3] passes the decay clamp at both ends.
CONSTANT_LEAF_DRAWS = {
    "scale": (0.5, 0.0), "bias": (0.1, 0.0), "ts_mu0": (0.3, 0.0),
    "ts_mu": (0.3, 0.0), "mix_k": (0.3, 0.5), "mix_r": (0.3, 0.5),
    "gn_scale": (0.3, 1.0), "bonus_u": (0.1, 0.0), "decay_w0": (2.0, -3.0),
    "rg_wa": (0.5, 0.0), "rg_ba": (0.5, 0.0), "rg_wi": (0.5, 0.0),
    "rg_bi": (0.5, 0.0), "conv_b": (0.1, 0.0)}


def init_norm(norm_type: str, d: int, *, device=None,
              dtype=torch.float32) -> dict:
    """A norm's parameters: rmsnorm ``{"scale"}``, layernorm ``{"scale",
    "bias"}``, both zeros (the norms apply ``1 + scale``); none for
    ``nonparametric_ln``."""
    if norm_type not in NORM_LEAVES:
        raise ValueError(norm_type)
    return {n: torch.zeros((d,), dtype=dtype, device=device)
            for n in NORM_LEAVES[norm_type]}


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions [..., S] -> (sin, cos) each [..., S, head_dim//2], fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exponent)
    angles = positions.to(torch.float32)[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """x [..., S, H, head_dim]; sin/cos [..., S, head_dim//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    sin_, cos_ = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_],
                     dim=-1).to(x.dtype)
