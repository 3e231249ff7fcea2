"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU gated recurrence
(port of ``repro/models/rglru.py``).

    y = W_down( GeLU(W_gate_br x) ⊙ RGLRU(conv4(W_x x)) )

RG-LRU (per channel, fp32):
    r_t = σ(w_a·x̃_t + b_a)        (recurrence gate)
    i_t = σ(w_i·x̃_t + b_i)        (input gate)
    log a_t = -c · softplus(Λ) · r_t
    h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x̃_t)

The sequence recurrence is a first-order linear recurrence, solved by
:func:`associative_scan`: the odd/even recursion of ``jax.lax
.associative_scan`` written out in torch, so the combines happen in the
reference's order (log depth, elementwise on the card).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch import nn

from repro_torch.models.common import Leaves, dense_init

RG_C = 8.0


def init_rglru_state(cfg, batch: int, *, device=None) -> dict:
    r = cfg.d_rnn or cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                dtype=torch.float32, device=device)}


def _interleave(a, b, dim: int):
    """a at the even, b at the odd positions along ``dim`` (len(a) is
    len(b) or len(b) + 1)."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``combine``, by the recursion of ``jax.lax.associative_scan``
    (pairs combined, the half-size scan recursed, the even elements fixed
    up), so every element is combined in the reference's order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.ndim
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]
    reduced = combine([sl(e, 0, n - 1, 2) for e in elems],
                      [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd],
                       [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return [a1 * a2, a2 * b1 + b2]


class RGLRU(Leaves):
    """The recurrent block's weights (the reference's ``init_rglru_block``;
    every method takes ``over``, leaves that replace the module's own)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, r = cfg.d_model, cfg.d_rnn or cfg.d_model
        dt = cfg.pdtype()
        kw = dict(generator=generator, device=device, dtype=dt)
        # Λ so that a^c is uniform in [0.9, 0.999] at r_t = 1 (Griffin)
        u = torch.empty((r,), dtype=torch.float32, device=device).uniform_(
            0.9, 0.999, generator=generator)
        lam = torch.log(torch.expm1(-torch.log(u) / RG_C))
        z = lambda: torch.zeros((r,), dtype=dt, device=device)  # noqa: E731
        p = {"w_x": dense_init((d, r), **kw),
             "w_gate_br": dense_init((d, r), **kw),
             "w_down": dense_init((r, d), **kw),
             "rg_lambda": lam.to(dt),
             "rg_wa": z(), "rg_ba": z(), "rg_wi": z(), "rg_bi": z(),
             "conv_w": (torch.randn((cfg.conv_width, r), generator=generator,
                                    device=device) * 0.1).to(dt),
             "conv_b": z()}
        for name, w in p.items():
            setattr(self, name, nn.Parameter(w))

    def _coeffs(self, xt, over):
        """-> (a, bx) fp32: h_t = a_t h_{t-1} + bx_t."""
        f = lambda name: self.w(name, over).to(torch.float32)  # noqa: E731
        x32 = xt.to(torch.float32)
        r_gate = torch.sigmoid(x32 * f("rg_wa") + f("rg_ba"))
        i_gate = torch.sigmoid(x32 * f("rg_wi") + f("rg_bi"))
        log_a = -RG_C * torch.nn.functional.softplus(f("rg_lambda")) * r_gate
        a = torch.exp(log_a)
        bx = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) \
            * (i_gate * x32)
        return a, bx

    def apply(self, x, state, length=None, over: Mapping = {}
              ) -> Tuple[torch.Tensor, dict]:
        """Sequence mode: x [B,T,D] from ``state`` -> (out, new state). With
        ``length`` only the first ``length`` tokens are valid (an engine
        chunk): the scan is a prefix scan, so the hidden carry is read at
        ``length - 1`` and the conv carry is the last ``conv_width - 1``
        valid inputs. Output rows past ``length`` are garbage."""
        t = x.shape[1]
        length = t if length is None else int(length)
        dt = x.dtype
        W = lambda name: self.w(name, over).to(dt)      # noqa: E731
        gate = torch.nn.functional.gelu(x @ W("w_gate_br"), approximate="tanh")
        xb = x @ W("w_x")
        wlen = self.cfg.conv_width
        xp = torch.cat([state["conv"].to(dt), xb], 1)
        xc = sum(xp[:, i:i + t] * W("conv_w")[wlen - 1 - i]
                 for i in range(wlen)) + W("conv_b")
        a, bx = self._coeffs(xc, over)
        # fold the carried state into the first step: h_1 = a_1 h_0 + bx_1
        bx = torch.cat([bx[:, :1] + a[:, :1] * state["h"][:, None], bx[:, 1:]],
                       1)
        _, hs = associative_scan(_combine, [a, bx], 1)
        out = (gate * hs.to(dt)) @ W("w_down")
        return out, {"h": hs[:, length - 1],
                     "conv": xp[:, length:length + wlen - 1].to(torch.float32)}

    def decode(self, x, state, over: Mapping = {}
               ) -> Tuple[torch.Tensor, dict]:
        """The one-token recurrence. x [B,1,D]."""
        dt = x.dtype
        W = lambda name: self.w(name, over).to(dt)      # noqa: E731
        gate = torch.nn.functional.gelu(x[:, 0] @ W("w_gate_br"),
                                        approximate="tanh")
        xb = x[:, 0] @ W("w_x")
        wlen = self.cfg.conv_width
        hist = torch.cat([state["conv"].to(dt), xb[:, None]], 1)
        cw = W("conv_w")
        xb = sum(hist[:, wlen - 1 - i] * cw[i] for i in range(wlen)) \
            + W("conv_b")
        a, bx = self._coeffs(xb, over)
        h = a * state["h"] + bx
        out = (gate * h.to(dt)) @ W("w_down")
        return out[:, None], {"h": h, "conv": hist[:, 1:].to(torch.float32)}

