"""GQA attention: short-prefill and cached decode (port of
``repro/models/attention.py``, the ``attn_impl='cp'`` path at
``s <= attn_chunk_threshold``).

Written as plain einsum + softmax rather than a fused attention call, so the
parity suite compares like with like against the reference. Query-chunked
prefill and the local-window ring wait (ROADMAP Queue 1 item 12.2).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import apply_rope, dense_init, rope_frequencies

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def _attend(q, k, v, mask):
    """q [B,S,K,G,hd], k/v [B,T,K,hd], mask broadcastable to [B,K,G,S,T]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bskgh,btkh->bkgst", q, k) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _causal_mask(q_pos, k_pos):
    """[..., S, T] boolean."""
    return q_pos[..., :, None] >= k_pos[..., None, :]


def init_kv_cache(cfg, batch: int, max_len: int, *, device=None, dtype=None):
    dt = dtype or cfg.cdtype()
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


class Attention(nn.Module):
    """wq/wk/wv/wo in the reference's [in, out] layout (``x @ w``)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        self.wq = nn.Parameter(dense_init((d, h * hd), **kw))
        self.wk = nn.Parameter(dense_init((d, k * hd), **kw))
        self.wv = nn.Parameter(dense_init((d, k * hd), **kw))
        self.wo = nn.Parameter(dense_init((h * hd, d), **kw))

    def project_qkv(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = cfg.cdtype()
        q = (x @ self.wq.to(dt)).reshape(b, s, h, hd)
        kk = (x @ self.wk.to(dt)).reshape(b, s, k, hd)
        vv = (x @ self.wv.to(dt)).reshape(b, s, k, hd)
        sin, cos = rope_frequencies(hd, cfg.rope_theta, positions)
        return apply_rope(q, sin, cos), apply_rope(kk, sin, cos), vv

    def full(self, x, positions):
        """Prefill: x [B,S,D] -> (out [B,S,D], k, v) — k/v seed the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        if s > cfg.attn_chunk_threshold:
            raise NotImplementedError(
                "query-chunked prefill waits (ROADMAP Queue 1 item 12.2)")
        q, k, v = self.project_qkv(x, positions)
        q = q.reshape(b, s, kh, h // kh, hd)
        mask = _causal_mask(positions[0], positions[0])[None, None, None]
        out = _attend(q, k, v, mask).reshape(b, s, h * hd)
        return out @ self.wo.to(x.dtype), k, v

    def decode(self, x, cache, pos):
        """Cache-append decode: x [B,S,D] -> (out [B,S,D], cache), the cache
        updated in place (a view's base included). ``pos`` is the number of
        tokens already cached: a [B] int64 tensor (continuous batching:
        batch row b writes rows [pos[b], pos[b]+S)) or an int, every row's.
        Rows past a row's position hold stale values; the causal mask
        (``k_pos <= q_pos``, per row) hides each until the step that
        overwrites it. The caller keeps every write below the cache length:
        an index past it raises here on the CPU and is a device-side assert
        on the card (the engine pads a ragged chunk only as far as
        ``max_len``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((b,), pos, dtype=torch.int64, device=x.device)
        positions = pos[:, None] + torch.arange(s, dtype=torch.int64,
                                                device=x.device)
        q, k_new, v_new = self.project_qkv(x, positions)
        q = q.reshape(b, s, kh, h // kh, hd)
        rows = torch.arange(b, device=x.device)[:, None]
        cache["k"][rows, positions] = k_new.to(cache["k"].dtype)
        cache["v"][rows, positions] = v_new.to(cache["v"].dtype)
        t = cache["k"].shape[1]
        k_pos = torch.arange(t, dtype=torch.int64, device=x.device)[None]
        mask = _causal_mask(positions, k_pos)[:, None, None]
        out = _attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
        return out.reshape(b, s, h * hd) @ self.wo.to(x.dtype), cache
