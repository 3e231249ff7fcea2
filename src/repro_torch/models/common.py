"""Shared layer primitives (port of ``repro/models/common.py``)."""
from __future__ import annotations

import math

import torch


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
