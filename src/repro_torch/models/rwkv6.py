"""RWKV6 ("Finch") time-mix block: attention-free, data-dependent decay
(port of ``repro/models/rwkv6.py``).

The matrix-valued state per head, ``S in R^{hd x hd}``, evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T           (w_t in (0,1), per channel)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Prefill runs the reference's chunked formulation in its order (chunks of
``CHUNK`` tokens carrying S: the inclusive cumprod of the decays, ``k / a``,
the strictly causal [C, C] product, the tail padded with w = 1 and
r = k = v = 0), so its rounding follows the reference's rather than a
token-by-token recurrence's. Decode is the one-step recurrence on the
carried state. The recurrence runs in fp32; the decays are clamped so the
``k / a`` rescaling stays inside fp32's range.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch import nn

from repro_torch.models.common import Leaves, dense_init

CHUNK = 16
TS_LORA = 32     # token-shift lora rank
W_LORA = 64      # decay lora rank


def init_rwkv_state(cfg, batch: int, *, device=None) -> dict:
    h, hd, d = cfg.n_heads, cfg.head_dim_, cfg.d_model
    z = lambda *s: torch.zeros(s, dtype=torch.float32,   # noqa: E731
                               device=device)
    return {"s": z(batch, h, hd, hd), "x_tmix": z(batch, d),
            "x_cmix": z(batch, d)}


def _group_norm(x, scale, h: int):
    """Per-head RMS normalization of the wkv output. x [B,T,H*hd]."""
    b, t, dh = x.shape
    xs = x.reshape(b, t, h, dh // h).to(torch.float32)
    var = xs.square().mean(-1, keepdim=True)
    out = (xs * torch.rsqrt(var + 1e-5)).reshape(b, t, dh)
    return (out * scale.to(torch.float32)).to(x.dtype)


def wkv_chunked(r, k, v, w, u, s0):
    """Chunked WKV6. r,k,v,w [B,T,H,hd] fp32; u [H,hd]; s0 [B,H,hd,hd].
    Returns (o [B,T,H,hd], the state after the last token)."""
    b, t, h, hd = r.shape
    pad = (-t) % CHUNK
    if pad:
        # identity-pad the tail: w = 1 (no decay), r = k = v = 0
        z = r.new_zeros((b, pad, h, hd))
        r, k, v = (torch.cat([a, z], 1) for a in (r, k, v))
        w = torch.cat([w, torch.ones_like(z)], 1)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.float32,
                                device=r.device), -1)       # strict lower
    s, outs = s0, []
    for c0 in range(0, t + pad, CHUNK):
        rr, kk, vv, ww = (a[:, c0:c0 + CHUNK] for a in (r, k, v, w))
        a = torch.cumprod(ww, dim=1)                        # inclusive
        a_prev = torch.cat([torch.ones_like(a[:, :1]), a[:, :-1]], 1)
        k_div = kk / a                                      # clamp-bounded
        r_sc = rr * a_prev
        # intra-chunk interaction [B,H,C,C] (strictly causal) + the bonus
        m = torch.einsum("bthc,bshc->bhts", r_sc, k_div) * tri
        diag = torch.einsum("bthc,bthc->bth", rr * u[None, None], kk)
        o = torch.einsum("bhts,bshd->bthd", m, vv) + diag[..., None] * vv
        # the carried state's contribution, then the state update
        o = o + torch.einsum("bthc,bhcd->bthd", r_sc, s)
        s = a[:, -1][..., None] * (
            s + torch.einsum("bshc,bshd->bhcd", k_div, vv))
        outs.append(o)
    return torch.cat(outs, 1)[:, :t], s


class TimeMix(Leaves):
    """The time-mix weights (the reference's ``init_rwkv_tmix``; every
    method takes ``over``, leaves that replace the module's own)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=device, dtype=dt)

        def randn(shape, s):
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * s).to(dt)
        p = {"w_r": dense_init((d, h * hd), **kw),
             "w_k": dense_init((d, h * hd), **kw),
             "w_v": dense_init((d, h * hd), **kw),
             "w_g": dense_init((d, h * hd), **kw),
             "w_o": dense_init((h * hd, d), **kw),
             # data-dependent token shift (5 targets: r, k, v, g, w)
             "ts_mu0": torch.zeros((d,), dtype=dt, device=device),
             "ts_mu": torch.zeros((5, d), dtype=dt, device=device),
             "ts_lora_a": dense_init((d, 5 * TS_LORA), **kw),
             "ts_lora_b": randn((5, TS_LORA, d), 0.01),
             # data-dependent decay w_t = exp(-exp(w0 + lora(x_w)))
             "decay_w0": torch.full((h * hd,), -6.0, dtype=dt, device=device),
             "decay_lora_a": dense_init((d, W_LORA), **kw),
             "decay_lora_b": randn((W_LORA, h * hd), 0.01),
             "bonus_u": randn((h, hd), 0.1),
             "gn_scale": torch.ones((h * hd,), dtype=dt, device=device)}
        for name, w in p.items():
            setattr(self, name, nn.Parameter(w))

    def _inputs(self, x, x_prev, over):
        """The five projections' inputs and their products: (r, k, v [B,T,
        H,hd] fp32, the gate g [B,T,H*hd], the decay w [B,T,H,hd])."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = cfg.n_heads, cfg.head_dim_
        dt = x.dtype
        W = lambda name: self.w(name, over).to(dt)      # noqa: E731
        # data-dependent lerp between x_t and x_{t-1}
        xp = torch.cat([x_prev.to(dt)[:, None], x[:, :-1]], 1)
        delta = xp - x
        base = x + delta * W("ts_mu0")
        lora = torch.tanh(base @ W("ts_lora_a")).reshape(b, t, 5, TS_LORA)
        offs = torch.einsum("btir,ird->ibtd", lora, W("ts_lora_b"))
        xs = x[None] + delta[None] * (W("ts_mu")[:, None, None, :] + offs)

        def proj(i, name):
            return (xs[i] @ W(name)).reshape(b, t, h, hd).to(torch.float32)
        r, k, v = proj(0, "w_r"), proj(1, "w_k"), proj(2, "w_v")
        g = torch.nn.functional.silu(xs[3] @ W("w_g"))
        raw = W("decay_w0") + torch.tanh(xs[4] @ W("decay_lora_a")) \
            @ W("decay_lora_b")
        w = torch.exp(-torch.exp(raw.to(torch.float32).clamp(-8.0, 1.0)))
        return r, k, v, g, w.reshape(b, t, h, hd)

    def _out(self, o, g, dt, over):
        b, t = o.shape[:2]
        o = _group_norm(o.reshape(b, t, -1).to(dt), self.w("gn_scale", over),
                        self.cfg.n_heads)
        return (o * g) @ self.w("w_o", over).to(dt)

    def apply(self, x, state, length=None, over: Mapping = {}
              ) -> Tuple[torch.Tensor, dict]:
        """Sequence mode: x [B,T,D] from ``state`` -> (out, new state). With
        ``length`` only the first ``length`` tokens are valid (an engine
        chunk): the padding is identity-masked out of the fold as the chunked
        scan pads its own tail, and the token-shift carry is read at the last
        valid token. Output rows past ``length`` are garbage."""
        t = x.shape[1]
        length = t if length is None else int(length)
        r, k, v, g, w = self._inputs(x, state["x_tmix"], over)
        if length < t:
            valid = torch.arange(t, device=x.device)[None, :, None,
                                                     None] < length
            r, k, v = (torch.where(valid, a, 0.0) for a in (r, k, v))
            w = torch.where(valid, w, 1.0)
        u = self.w("bonus_u", over).to(torch.float32)
        o, s = wkv_chunked(r, k, v, w, u, state["s"])
        out = self._out(o, g, x.dtype, over)
        return out, {"s": s, "x_tmix": x[:, length - 1].to(torch.float32),
                     "x_cmix": state["x_cmix"]}

    def decode(self, x, state, over: Mapping = {}
               ) -> Tuple[torch.Tensor, dict]:
        """The one-token recurrence. x [B,1,D]."""
        r, k, v, g, w = (a[:, 0] for a in self._inputs(x, state["x_tmix"],
                                                        over))
        u = self.w("bonus_u", over).to(torch.float32)
        s = state["s"]
        kv = k[..., :, None] * v[..., None, :]                 # [B,H,hd,hd]
        o = torch.einsum("bhc,bhcd->bhd", r, s + u[None, ..., None] * kv)
        s = w[..., None] * s + kv
        out = self._out(o[:, None], g[:, None], x.dtype, over)
        return out, {"s": s, "x_tmix": x[:, -1].to(torch.float32),
                     "x_cmix": state["x_cmix"]}
