"""GQA attention: full, local-window and query-chunked prefill, cached
decode and the local-window ring (port of ``repro/models/attention.py``,
the ``attn_impl='cp'`` path; above ``attn_chunk_threshold`` the query axis
runs in chunks of ``attn_chunk_q``, as the reference's ``_q_chunked``).

Written as plain einsum + softmax rather than a fused attention call, so the
parity suite compares like with like against the reference.

``kv_cache_dtype="int8"`` makes :func:`init_kv_cache` (the engine's K/V
rows) int8 values with one bf16 scale a (token, kv head): a decode write
quantizes the new rows (:func:`quant_kv`) and the read dequantizes the whole
cache (:func:`dequant_kv`), as the reference's ``decode_attention``. The
prefill's K/V rows and the local-window ring keep the compute dtype there,
and so here.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from repro_torch.models.common import (Leaves, apply_rope, dense_init,
                                       rope_frequencies)

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def _attend(q, k, v, mask):
    """q [B,S,K,G,hd], k/v [B,T,K,hd], mask broadcastable to [B,K,G,S,T]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bskgh,btkh->bkgst", q, k) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _attend_mha(q, k, v, mask):
    """q/k/v [B,S|T,H,hd] (kv expanded), mask broadcast to [B,H,S,T]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _expand_kv(k, g: int):
    """[B,T,K,hd] -> [B,T,K*g,hd] (each kv head repeated over its q group)."""
    return k if g == 1 else k.repeat_interleave(g, dim=2)


def _causal_mask(q_pos, k_pos, window: int = 0):
    """[..., S, T] boolean; a local-window band when ``window`` > 0."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        m = m & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    return m


def _q_chunked(q, k, v, positions, window: int, chunk: int):
    """Query chunks in turn; logits bounded to [B,H,chunk,T]. q/k/v
    [B,S,H,hd] (kv expanded)."""
    s = q.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} must divide the q-chunk size {chunk}")
    outs = []
    for c0 in range(0, s, chunk):
        mask = _causal_mask(positions[0, c0:c0 + chunk], positions[0],
                            window)[None, None]
        outs.append(_attend_mha(q[:, c0:c0 + chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def _zero_kv(cfg, batch: int, rows: int, dt, device) -> dict:
    shape = (batch, rows, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_kv_cache(cfg, batch: int, max_len: int, *, device=None, dtype=None):
    """Zero K/V rows [batch, max_len, n_kv_heads, head_dim]; under
    ``kv_cache_dtype="int8"`` int8 values plus bf16 ``k_scale`` /
    ``v_scale`` [batch, max_len, n_kv_heads, 1]."""
    if cfg.kv_cache_dtype == "int8":
        cache = _zero_kv(cfg, batch, max_len, torch.int8, device)
        shape = (batch, max_len, cfg.n_kv_heads, 1)
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)
        return cache
    return _zero_kv(cfg, batch, max_len, dtype or cfg.cdtype(), device)


def quant_kv(x):
    """[..., hd] -> (int8 values, bf16 scale [..., 1]): the scale is
    max|x| / 127 in float32, floored at 1e-8; the quotient is taken in
    float32 against that float32 scale, rounded half to even and clipped
    to +-127 before the cast (so it cannot wrap); the scale is rounded to
    bf16 only for storage."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequant_kv(q, scale, dt):
    return q.to(dt) * scale.to(dt)


def init_local_cache(cfg, batch: int, window: int, *, device=None,
                     dtype=None):
    """Rolling-window ring for local attention: O(window) rows whatever the
    decode length; ring slot ``pos % window`` is overwritten and each slot's
    absolute position (``-1``: empty) drives the mask. The ring keeps the
    compute dtype under ``kv_cache_dtype="int8"``, as the reference's."""
    ring = _zero_kv(cfg, batch, window, dtype or cfg.cdtype(), device)
    ring["pos"] = torch.full((batch, window), -1, dtype=torch.int64,
                             device=device)
    return ring


class Attention(Leaves):
    """wq/wk/wv/wo in the reference's [in, out] layout (``x @ w``). Every
    method takes ``over``, leaves that replace the module's own for the
    call (:class:`~repro_torch.models.common.Leaves`)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        self.wq = nn.Parameter(dense_init((d, h * hd), **kw))
        self.wk = nn.Parameter(dense_init((d, k * hd), **kw))
        self.wv = nn.Parameter(dense_init((d, k * hd), **kw))
        self.wo = nn.Parameter(dense_init((h * hd, d), **kw))

    def project_qkv(self, x, positions, over: Mapping = {}):
        cfg = self.cfg
        b, s, _ = x.shape
        h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        dt = cfg.cdtype()
        q = (x @ self.w("wq", over).to(dt)).reshape(b, s, h, hd)
        kk = (x @ self.w("wk", over).to(dt)).reshape(b, s, k, hd)
        vv = (x @ self.w("wv", over).to(dt)).reshape(b, s, k, hd)
        sin, cos = rope_frequencies(hd, cfg.rope_theta, positions)
        return apply_rope(q, sin, cos), apply_rope(kk, sin, cos), vv

    def _out(self, out, x, over):
        b, s = out.shape[:2]
        return out.reshape(b, s, -1) @ self.w("wo", over).to(x.dtype)

    def full(self, x, positions, window: int = 0, over: Mapping = {}):
        """Prefill: x [B,S,D] -> (out [B,S,D], k, v); k/v seed the cache.
        ``window`` > 0 bands the mask (local attention); above
        ``attn_chunk_threshold`` the queries run in chunks."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        q, k, v = self.project_qkv(x, positions, over)
        if s > cfg.attn_chunk_threshold:
            out = _q_chunked(q, _expand_kv(k, h // kh), _expand_kv(v, h // kh),
                             positions, window, cfg.attn_chunk_q)
        else:
            q = q.reshape(b, s, kh, h // kh, hd)
            mask = _causal_mask(positions[0], positions[0],
                                window)[None, None, None]
            out = _attend(q, k, v, mask)
        return self._out(out, x, over), k, v

    def decode(self, x, cache, pos, over: Mapping = {}):
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
        positions = _positions(pos, b, s, x.device)
        q, k_new, v_new = self.project_qkv(x, positions, over)
        q = q.reshape(b, s, kh, h // kh, hd)
        rows = torch.arange(b, device=x.device)[:, None]
        if "k_scale" in cache:
            new = dict(zip(("k", "k_scale"), quant_kv(k_new)))
            new.update(zip(("v", "v_scale"), quant_kv(v_new)))
        else:
            new = {"k": k_new, "v": v_new}
        for name, val in new.items():
            cache[name][rows, positions] = val.to(cache[name].dtype)
        if "k_scale" in cache:
            ck = dequant_kv(cache["k"], cache["k_scale"], q.dtype)
            cv = dequant_kv(cache["v"], cache["v_scale"], q.dtype)
        else:
            ck, cv = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        t = cache["k"].shape[1]
        k_pos = torch.arange(t, dtype=torch.int64, device=x.device)[None]
        mask = _causal_mask(positions, k_pos)[:, None, None]
        out = _attend(q, ck, cv, mask)
        return self._out(out, x, over), cache

    def advance_local(self, x, ring, pos, length=None, over: Mapping = {}):
        """Local attention against the rolling ring, in place: x [B,S,D] at
        offset ``pos`` (an int or a [B] tensor; S = 1 is a decode step, S > 1
        one prompt chunk whose first ``length`` tokens are valid). Valid rows
        scatter into ring slots ``(pos + i) % W``; pad rows are dropped, so
        they never clobber a slot an earlier query's window still needs. S
        must not exceed the ring (the engine clamps its chunk to the
        window). Output rows past ``length`` are garbage the caller
        ignores."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        w = ring["k"].shape[1]
        if s > w:
            raise ValueError(f"chunk {s} exceeds the local ring ({w} slots)")
        length = s if length is None else int(length)
        positions = _positions(pos, b, s, x.device)
        q, k_new, v_new = self.project_qkv(x, positions, over)
        q = q.reshape(b, s, kh, h // kh, hd)
        pv = positions[:, :length]
        rows = torch.arange(b, device=x.device)[:, None]
        slots = torch.remainder(pv, w)
        ring["k"][rows, slots] = k_new[:, :length].to(ring["k"].dtype)
        ring["v"][rows, slots] = v_new[:, :length].to(ring["v"].dtype)
        ring["pos"][rows, slots] = pv
        cpos = ring["pos"][:, None, :]                         # [B,1,W]
        qp = positions[:, :, None]                             # [B,S,1]
        valid = (cpos >= 0) & (cpos <= qp) & ((qp - cpos) < cfg.local_window)
        out = _attend(q, ring["k"].to(q.dtype), ring["v"].to(q.dtype),
                      valid[:, None, None])
        return self._out(out, x, over), ring


def _positions(pos, b: int, s: int, device) -> torch.Tensor:
    """[B, S] absolute positions of S new tokens at offset ``pos`` (an int,
    every row's, or a [B] tensor)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((b,), int(pos), dtype=torch.int64, device=device)
    return pos[:, None] + torch.arange(s, dtype=torch.int64, device=device)
