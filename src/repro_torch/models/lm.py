"""Decoder LM over every block kind (port of ``repro/models/lm.py``).

A model is a cycle of block kinds (``cfg.block_pattern``) over ``n_layers``:

  * ``attn``  — GQA attention + dense MLP          (the dense family)
  * ``local`` — windowed attention + dense MLP      (recurrentgemma 1/3 layers)
  * ``moe``   — GQA attention + MoE FFN             (qwen3-moe, dbrx)
  * ``rwkv``  — RWKV6 time-mix + channel-mix        (attention-free)
  * ``rec``   — RG-LRU recurrent block + dense MLP  (recurrentgemma 2/3 layers)

with rmsnorm, layernorm or OLMo's non-parametric norm, and text or a
``vision_stub`` / ``audio_stub`` prefix of precomputed embeddings.

The reference stacks the layers into pattern groups (``groups/blk{i}``
leaves [G, ...], one per position of the pattern) plus an unstacked
``tail`` of the ``n_layers % len(pattern)`` last layers; the port holds one
:class:`Block` module per layer (:func:`repro_torch.convert.layer_slots`
maps one layout onto the other). In the reference's layout the 2-D leaves
are ``embed``, ``unembed``, the group leaves whose per-layer shape is 1-D
(the norms, RWKV's vectors, RG-LRU's gates) and the tail's matrices, so
those are the leaves a deployment packs (:meth:`LM.cim_leaves`), AdamW
decays and alignment aligns.

Serving reads the CIM leaves from a ``params`` dict (``{"embed",
"unembed"}`` -> tensor or :class:`~repro_torch.core.cim.CIMStore`, any
other reference-layout leaf as a tensor that replaces the module's own,
plus an optional ``"_cim"`` dynamic-injection runtime) — what
:meth:`CIMDeployment.serving_params` returns (the hbm path decodes every
2-D leaf from its image; an expert deployment restacks the MoE weights). A
CIMStore embed is decoded row by row at gather time; a CIMStore unembed goes
through :func:`~repro_torch.core.deployment.dispatch_linear`, the fused
kernel on the card. Without ``params`` the module's own weights serve.

:meth:`LM.forward` returns full-sequence logits (the reference's
``lm.forward``, on a token tensor or the reference's batch dict);
:func:`forward` runs it on a parameter tree in the reference's layout, as
the sweep engine hands one to an ``eval_fn`` and as the training step
differentiates it (through a weightless :func:`shell`). Serving and the
engine are text-only, as the reference's. Training takes every kind: the
step differentiates :func:`forward` with ``with_aux=True`` (the MoE layers'
aux loss joins the loss, as the reference's ``loss_fn`` adds it).

The continuous-batching engine (:mod:`repro_torch.launch.engine`) speaks the
slot-state protocol: :class:`SlotStateSpec` per block kind,
:func:`init_slot_states`, :meth:`LM.prefill_chunk`, :meth:`LM.decode_slots`,
:func:`extract_state_chunk` and :func:`inject_state_chunk`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.core import cim as cim_lib
from repro_torch.core import deployment as dep_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.cim_read import ops as cr_ops
from repro_torch.models.attention import (Attention, init_kv_cache,
                                          init_local_cache)
from repro_torch.models.common import apply_norm, embed_init, init_norm
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import EXPERT_LEAF_NAMES, MoE, drop_free
from repro_torch.models.rglru import RGLRU, init_rglru_state
from repro_torch.models.rwkv6 import TimeMix, init_rwkv_state


def _norm(cfg, device) -> nn.ParameterDict:
    """One norm's parameters as a module (empty for ``nonparametric_ln``)."""
    return nn.ParameterDict({n: nn.Parameter(w) for n, w in init_norm(
        cfg.norm_type, cfg.d_model, device=device,
        dtype=cfg.pdtype()).items()})


class Block(nn.Module):
    """One layer of kind ``kind``: norm1 -> mixer -> residual, norm2 -> FFN
    -> residual. The mixer is attention (``attn``, ``moe``; windowed for
    ``local``), RWKV6's time mix (``tmix``) or the RG-LRU block (``rec``);
    the FFN the MLP, the MoE or RWKV's channel mix (``cmix``). Every method
    takes ``over``, ``{module: {leaf: tensor}}`` leaves that replace the
    block's own for the call (:meth:`LM._over`)."""

    def __init__(self, cfg, kind: str, *, generator=None, device=None):
        super().__init__()
        if kind not in ENGINE_KINDS:
            raise ValueError(f"block kind {kind!r}; allowed: "
                             f"{', '.join(repr(k) for k in ENGINE_KINDS)}")
        self.cfg, self.kind = cfg, kind
        kw = dict(generator=generator, device=device)
        if kind in ("attn", "local", "moe"):
            self.attn = Attention(cfg, **kw)
        elif kind == "rwkv":
            self.tmix = TimeMix(cfg, **kw)
        else:
            self.rec = RGLRU(cfg, **kw)
        if kind == "moe":
            self.moe = MoE(cfg, **kw)
        elif kind == "rwkv":
            self.cmix = MLP(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)
        self.norm1 = _norm(cfg, device)
        self.norm2 = _norm(cfg, device)

    def _n(self, which: str, x, over):
        own = getattr(self, which)
        o = over.get(which)
        p = own if o is None else {n: o.get(n, w) for n, w in own.items()}
        return apply_norm(self.cfg.norm_type, p, x)

    def _ffn(self, x, over):
        """norm2 -> MLP or MoE -> residual; -> (x, aux)."""
        h = self._n("norm2", x, over)
        if self.kind == "moe":
            out, aux = self.moe(h, over.get("moe", {}))
            return x + out, aux
        return x + self.mlp(h, over=over.get("mlp", {})), None

    def _cmix(self, x, shifted_first, length, over):
        """RWKV's norm2 -> channel mix -> residual, the token shift carried
        in from ``shifted_first`` [B, D]; -> (x, the x_cmix carry)."""
        h2 = self._n("norm2", x, over)
        h2s = torch.cat([shifted_first.to(h2.dtype)[:, None], h2[:, :-1]], 1)
        x = x + self.cmix(h2, h2s, over.get("cmix", {}))
        return x, h2[:, length - 1].to(torch.float32)

    def prefill(self, x, positions, over: Mapping = {}):
        """Sequence mode from a zero state -> (x, aux or None, state): the
        layer's K/V rows ``{"k", "v"}`` (``attn``, ``moe``), its ring of
        ``local_window`` slots holding the last rows (``local``), or its
        fold state (``rwkv``, ``rec``)."""
        cfg, kind = self.cfg, self.kind
        b, s, _ = x.shape
        h = self._n("norm1", x, over)
        if kind in ("attn", "local", "moe"):
            window = cfg.local_window if kind == "local" else 0
            out, k, v = self.attn.full(h, positions, window,
                                       over.get("attn", {}))
            x, aux = self._ffn(x + out, over)
            state = {"k": k, "v": v}
            if kind == "local":
                w = min(cfg.local_window, s)
                state = init_local_cache(cfg, b, cfg.local_window,
                                         device=x.device, dtype=k.dtype)
                pw = positions[:, -w:]
                slots = torch.remainder(pw[0], cfg.local_window)
                state["k"][:, slots] = k[:, -w:]
                state["v"][:, slots] = v[:, -w:]
                state["pos"][:, slots] = pw
            return x, aux, state
        if kind == "rwkv":
            o, state = self.tmix.apply(
                h, init_rwkv_state(cfg, b, device=x.device),
                over=over.get("tmix", {}))
            x, state["x_cmix"] = self._cmix(x + o, torch.zeros_like(x[:, 0]),
                                            s, over)
            return x, None, state
        o, state = self.rec.apply(h, init_rglru_state(cfg, b,
                                                      device=x.device),
                                  over=over.get("rec", {}))
        return self._ffn(x + o, over)[0], None, state

    def step(self, x, state, pos, length=None, over: Mapping = {}):
        """Advance the layer's state by x [B,S,D] at offset ``pos`` (an int,
        or a [B] tensor of per-row positions) -> (x, new state). Without
        ``length`` a decode step (S = 1, a fold's one-step recurrence);
        with it x is one prompt chunk whose first ``length`` tokens are
        valid (a fold's chunked form, as the reference advances it). Row
        and ring states are written in place (the returned state is
        ``state``); a fold state comes back new, for the caller to store
        (or, for an idle slot, to drop)."""
        kind = self.kind
        last = x.shape[1] if length is None else int(length)
        h = self._n("norm1", x, over)
        if kind in ("attn", "moe"):
            # position-parallel: pad rows land where the causal mask hides
            # them until a later write overwrites them
            out, state = self.attn.decode(h, state, pos,
                                          over.get("attn", {}))
            return self._ffn(x + out, over)[0], state
        if kind == "local":
            out, state = self.attn.advance_local(h, state, pos, last,
                                                 over.get("attn", {}))
            return self._ffn(x + out, over)[0], state
        if kind == "rwkv":
            tm = over.get("tmix", {})
            o, new = self.tmix.decode(h, state, tm) if length is None \
                else self.tmix.apply(h, state, last, tm)
            x, new["x_cmix"] = self._cmix(x + o, state["x_cmix"], last, over)
            return x, new
        rc = over.get("rec", {})
        o, new = self.rec.decode(h, state, rc) if length is None \
            else self.rec.apply(h, state, last, rc)
        return self._ffn(x + o, over)[0], new


def _store(state: dict, new: dict, keep=None) -> None:
    """Write a fold state ``new`` into ``state`` in place (a view's base
    included); with ``keep`` [B] bools, rows where it is False keep their
    old value."""
    if new is state:
        return
    for n, t in state.items():
        v = new[n]
        if keep is not None:
            v = torch.where(keep.reshape((-1,) + (1,) * (v.ndim - 1)), v, t)
        t.copy_(v)


def _cim_read_state(params, pos: int, leaf: str, req_salt=None):
    """(per-plane seeds, thr_man, thr_meta, model) of one CIM read, or
    (None, 0, 0, None) when no ``_cim`` runtime rides in ``params`` (static
    reads). Seeds fold per leaf, per request (``req_salt``, the serving
    engine's; None skips that link) and per read index ``pos``. A fault
    model in the runtime shapes the streams: drift keys its tick on ``pos``,
    folded into the thresholds returned here, so the model handed on
    carries tick 0."""
    rt = params.get("_cim")
    if rt is None:
        return None, 0, 0, None
    seeds = dep_lib.request_read_seeds(rt["seeds"], dep_lib.leaf_salt(leaf),
                                       req_salt, pos)
    return (seeds,) + dep_lib.read_thresholds(rt, pos)


def _embed_lookup(params, cfg, tokens, pos: int = 0, req_salt=None):
    """Token embedding gather; a CIMStore leaf decodes only the gathered rows
    (:func:`dispatch_read_rows`)."""
    emb = params["embed"]
    if isinstance(emb, cim_lib.CIMStore):
        seeds, tm, tt, model = _cim_read_state(params, pos, "embed", req_salt)
        rows = dep_lib.dispatch_read_rows(emb, tokens, seeds=seeds,
                                          thr_man=tm, thr_meta=tt, model=model)
        return rows.to(cfg.cdtype())
    return emb.to(cfg.cdtype())[tokens]


def _unembed_logits(params, x, pos: int = 0, req_salt=None):
    """Final projection; a CIMStore leaf routes through
    :func:`dispatch_linear` (the fused decode-on-read kernel on the card)."""
    w_un = params["unembed"]
    if isinstance(w_un, cim_lib.CIMStore):
        seeds, tm, tt, model = _cim_read_state(params, pos, "unembed",
                                               req_salt)
        scalars = cr_ops.make_scalars(seeds, tm, tt, model=model) \
            if seeds is not None else None
        return dep_lib.dispatch_linear(x, w_un, scalars=scalars, model=model)
    return x @ w_un.to(x.dtype)


class LM(nn.Module):
    """Decoder: embed (or a stub prefix) -> one :class:`Block` a layer ->
    final norm -> unembed. Built on ``device`` (default ``cuda``; pass
    ``"cpu"`` for the plain path)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        # None means cuda and raises without a card; "meta" holds shapes
        # only (:func:`shell`)
        device = resolve_device(device)
        dt = cfg.pdtype()
        self.embed = nn.Parameter(embed_init(
            (cfg.vocab_size, cfg.d_model), generator=generator, device=device,
            dtype=dt))
        self.unembed = nn.Parameter(embed_init(
            (cfg.d_model, cfg.vocab_size), generator=generator, device=device,
            dtype=dt))
        self.blocks = nn.ModuleList(
            [Block(cfg, kind, generator=generator, device=device)
             for kind in layer_kinds(cfg)])
        self.final_norm = _norm(cfg, device)
        # reference-layout prefix (groups/blk{i}, tail/{j}) -> [(layer, row
        # of its stacked leaves or None)]
        self._slots = {}
        for layer, (prefix, row) in enumerate(convert.layer_slots(cfg)):
            self._slots.setdefault(prefix, []).append((layer, row))
        # The module's own weights serve inference only. Training
        # differentiates a reference-layout tree through :func:`forward`,
        # which never reads these, so the flag does not touch it.
        self.requires_grad_(False)

    def cim_leaves(self) -> dict:
        """The leaves the reference's deployment can pack, in flatten order:
        its 2-D float leaves (``embed``, ``unembed``, the group leaves that
        are 1-D a layer, stacked [G, d], and the tail's matrices;
        :func:`convert.two_d_leaves`)."""
        return convert.two_d_leaves(self)

    def _params(self, params):
        p = {"embed": self.embed, "unembed": self.unembed}
        p.update(params or {})
        return p

    def _over(self, params):
        """([{module: {leaf: tensor}}] a layer, the final norm's mapping):
        the leaves of a serving dict in the reference's layout that replace
        the modules' own (a stacked ``groups/blk{i}/...`` leaf gives each of
        its layers its row; ``tail/{j}/...`` one layer all of it)."""
        over = [{} for _ in self.blocks]
        final = dict(self.final_norm.items())
        for path, t in params.items():
            if path in ("embed", "unembed", "_cim"):
                continue
            if path.startswith("final_norm/"):
                final[path.split("/", 1)[1]] = t
                continue
            prefix, mod, name = path.rsplit("/", 2)
            for layer, row in self._slots[prefix]:
                over[layer].setdefault(mod, {})[name] = \
                    t if row is None else t[row]
        return over, final

    def _final(self, x, norm):
        return apply_norm(self.cfg.norm_type, norm, x)

    def _embed_inputs(self, params, batch):
        """The reference's ``_embed_inputs``: a ``vision_stub`` batch's patch
        embeddings come before its token embeddings; an ``audio_stub``
        batch's ``embeds`` take the place of the token gather."""
        cfg = self.cfg
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        if cfg.modality == "vision_stub" and "vision_embeds" in batch:
            tok = _embed_lookup(params, cfg, batch["tokens"])
            return torch.cat([batch["vision_embeds"].to(cfg.cdtype()), tok],
                             dim=1)
        if cfg.modality == "audio_stub" and "embeds" in batch:
            return batch["embeds"].to(cfg.cdtype())
        return _embed_lookup(params, cfg, batch["tokens"])

    def forward(self, batch, params=None, *, unembed: bool = True,
                with_aux: bool = False):
        """``batch`` (tokens [B, S], or the reference's batch dict:
        ``tokens``, with ``vision_embeds`` [B, P, D] or ``embeds`` [B, S, D]
        for a stub modality) -> logits [B, S, V] at every position (no
        caches, reads at read index 0); with ``unembed=False`` the
        final-normed hidden states [B, S, D] that the unembed multiplies;
        with ``with_aux`` also the MoE layers' summed aux loss."""
        params = self._params(params)
        over, final = self._over(params)
        x = self._embed_inputs(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk, o in zip(self.blocks, over):
            x, a, _ = blk.prefill(x, positions, o)
            if a is not None:
                aux = aux + a
        x = self._final(x, final)
        out = _unembed_logits(params, x, pos=0) if unembed else x
        return (out, aux) if with_aux else out

    def prefill(self, tokens: torch.Tensor, params=None, max_len=None):
        """tokens [B, S] -> (last-token logits [B, V], caches). K/V caches
        hold ``max_len`` (default S) positions, a ``local`` ring its window;
        reads happen at read index 0."""
        cfg = self.cfg
        params = self._params(params)
        over, final = self._over(params)
        x = _embed_lookup(params, cfg, tokens, pos=0)
        b, s, _ = x.shape
        max_len = max_len or s
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        layers = []
        for blk, o in zip(self.blocks, over):
            x, _, state = blk.prefill(x, positions, o)
            if blk.kind in ("attn", "moe"):
                k, v = state["k"], state["v"]
                state = {"k": k.new_zeros((b, max_len) + k.shape[2:]),
                         "v": v.new_zeros((b, max_len) + v.shape[2:])}
                state["k"][:, :s] = k
                state["v"][:, :s] = v
            layers.append(state)
        x = self._final(x[:, -1:], final)
        logits = _unembed_logits(params, x, pos=0)[:, 0]
        return logits, {"layers": layers, "pos": s}

    def decode(self, caches, tokens: torch.Tensor, params=None):
        """One decode step at read index ``caches['pos']``. tokens [B, 1] ->
        (logits [B, V], caches); the caches update in place."""
        params = self._params(params)
        over, final = self._over(params)
        pos = caches["pos"]
        x = _embed_lookup(params, self.cfg, tokens, pos=pos)
        for blk, state, o in zip(self.blocks, caches["layers"], over):
            x, new = blk.step(x, state, pos, over=o)
            _store(state, new)
        x = self._final(x, final)
        logits = _unembed_logits(params, x, pos=pos)[:, 0]
        return logits, {"layers": caches["layers"], "pos": pos + 1}

    # ---------------------------------------------- continuous batching

    def _rows(self, caches) -> Optional[int]:
        """The slot states' K/V row count (None with no ``'rows'`` layer:
        rings and folds take any position)."""
        for blk, state in zip(self.blocks, caches["layers"]):
            if SLOT_STATE_SPECS[blk.kind].cache_unit == "rows":
                return state["k"].shape[1]
        return None

    def prefill_chunk(self, caches, tokens: torch.Tensor, slot: int,
                      pos: int, length: Optional[int] = None,
                      req_salt: Optional[int] = None, params=None):
        """Chunked prefill of ONE slot of the engine's slot states
        (:func:`init_slot_states`): ``tokens`` [C] is one prompt chunk whose
        first ``length`` entries are valid, at positions [pos, pos + C) of
        slot ``slot``. The ragged tail is padding: attn/moe pad K/V rows stay
        causally masked until later writes overwrite them, local drops pad
        ring writes, rwkv/rec mask pads out of their fold. A chunk at
        ``pos == 0`` starts a fresh request, so the slot's fold states
        (``rwkv``, ``rec``) are zeroed first: the previous occupant's fold
        would otherwise leak into it. The chunk reads the CIM image once, at
        read index ``pos`` with the request salt ``req_salt``. Returns the
        last valid token's logits [V]; the slot's position becomes
        ``pos + length``."""
        cfg = self.cfg
        check_engine_kinds(cfg)
        c = tokens.shape[0]
        length = c if length is None else int(length)
        max_len = self._rows(caches)
        if not 1 <= length <= c or pos < 0 or \
                (max_len is not None and pos + c > max_len):
            raise ValueError(f"prefill_chunk: rows [{pos}, {pos + c}) with "
                             f"{length} valid do not fit the {max_len}-row "
                             f"slot state")
        params = self._params(params)
        over, final = self._over(params)
        x = _embed_lookup(params, cfg, tokens[None], pos=pos,
                          req_salt=req_salt)
        for blk, state, o in zip(self.blocks, caches["layers"], over):
            view = {n: t[slot:slot + 1] for n, t in state.items()}
            if pos == 0 and SLOT_STATE_SPECS[blk.kind].fold_state:
                for t in view.values():
                    t.zero_()
            x, new = blk.step(x, view, pos, length, over=o)
            _store(view, new)
        h = self._final(x, final)[:, length - 1:length]
        logits = _unembed_logits(params, h, pos=pos, req_salt=req_salt)
        caches["pos_host"][slot] = pos + length
        caches["pos"][slot] = pos + length
        return logits[0, 0], caches

    def decode_slots(self, caches, tokens: torch.Tensor, active,
                     req_salts=None, params=None):
        """One continuous-batching decode step across the slot batch.

        ``tokens`` [S, 1] holds each slot's last token, ``active`` [S] bools
        which slots decode; each slot decodes at its own position (the
        slot states' ``pos``, read on the host from ``pos_host``, so the
        step never waits on the card for them). ``req_salts`` [S] (see
        :func:`deployment.request_salt`) key each slot's dynamic CIM reads
        by (request, position), never by slot index or engine step: under
        a ``_cim`` runtime the embed gather and the unembed are read one
        slot at a time, every slot including the inactive ones, each with
        its own seeds, so a request's logits and fault streams are the same
        served alone or co-batched. Static images are read batched.
        Inactive slots' positions do not advance: their stale K/V and ring
        writes stay masked, and their fold states (``rwkv``, ``rec``, which
        no position gates) keep their old value, so an idle slot's garbage
        token never advances a fold. Returns (logits [S, V], caches)."""
        cfg = self.cfg
        check_engine_kinds(cfg)
        dynamic = params is not None and params.get("_cim") is not None
        if dynamic and req_salts is None:
            raise ValueError(
                "decode_slots: params carry a dynamic-injection '_cim' "
                "runtime but no req_salts; per-read seeds would alias across "
                "requests: pass deployment.request_salt(rid) per slot")
        params = self._params(params)
        over, final = self._over(params)
        pos_host = caches["pos_host"]
        max_len = self._rows(caches)
        if max_len is not None and (pos_host >= max_len).any():
            raise ValueError(f"decode_slots: a slot at position "
                             f"{int(pos_host.max())} has no row left of "
                             f"{max_len}")
        s = tokens.shape[0]
        if dynamic and isinstance(params["embed"], cim_lib.CIMStore):
            x = torch.cat([_embed_lookup(params, cfg, tokens[i:i + 1],
                                         pos=int(pos_host[i]),
                                         req_salt=int(req_salts[i]))
                           for i in range(s)])
        else:
            x = _embed_lookup(params, cfg, tokens)
        # the idle-slot mask, built at the first fold state (attention
        # writes its rows and rings in place and needs none)
        keep = None
        for blk, state, o in zip(self.blocks, caches["layers"], over):
            x, new = blk.step(x, state, caches["pos"], over=o)
            if new is not state:
                if keep is None:
                    keep = torch.as_tensor(np.asarray(active, bool),
                                           device=x.device)
                _store(state, new, keep)
        x = self._final(x, final)
        if dynamic and isinstance(params["unembed"], cim_lib.CIMStore):
            logits = torch.cat([_unembed_logits(params, x[i:i + 1],
                                                pos=int(pos_host[i]),
                                                req_salt=int(req_salts[i]))
                                for i in range(s)])
        else:
            logits = _unembed_logits(params, x)
        pos_host += np.asarray(active, dtype=np.int64)
        caches["pos"].copy_(torch.from_numpy(pos_host))
        return logits[:, 0], caches


# ------------------------------------------------- continuous-batching engine
#
# Slot-state protocol: the engine/model boundary. Every block kind declares a
# SlotStateSpec; the engine drives init_slot_states / LM.prefill_chunk /
# LM.decode_slots / extract_state_chunk / inject_state_chunk against it and
# never looks inside a block's state.

ENGINE_KINDS = ("attn", "local", "moe", "rwkv", "rec")

_SPEC_VOCAB = {"kind": ENGINE_KINDS,
               "advance": ("parallel", "scan"),
               "cache_unit": ("rows", "state")}


@dataclasses.dataclass(frozen=True)
class SlotStateSpec:
    """Per-block-kind contract of the serving engine's slot-state protocol.

    * ``advance``: how a prompt chunk enters the state, ``'parallel'``
      (position-parallel attention over K/V rows or ring slots) or
      ``'scan'`` (a strictly recurrent left fold).
    * ``cache_unit``: the prefix cache's unit of reuse: ``'rows'`` states
      are position-addressable (a chunk extracts and injects the rows it
      wrote); ``'state'`` kinds cache the whole post-chunk state snapshot
      per trie node, exact because the state is a pure left fold over the
      salted prefix.
    * ``fold_state``: the state is a destructive left fold with no position
      gating: the engine zeroes it on admission (``pos == 0``) and freezes
      it for inactive slots, where attention-style states rely on the mask
      to hide stale rows until overwritten.
    * ``window_bound``: the state is a rolling window: the engine clamps
      its prefill chunk to the window so valid writes never collide.
    * ``capacity_coupled``: co-batched tokens may couple through
      capacity-based dispatch; :func:`repro_torch.models.moe.drop_free`
      decides whether an engine shape voids the bitwise guarantee.

    Unknown vocabulary fails at construction."""
    kind: str
    advance: str = "parallel"
    cache_unit: str = "rows"
    fold_state: bool = False
    window_bound: bool = False
    capacity_coupled: bool = False

    def __post_init__(self):
        for field, allowed in _SPEC_VOCAB.items():
            got = getattr(self, field)
            if got not in allowed:
                raise ValueError(
                    f"SlotStateSpec.{field}: unknown value {got!r}; allowed: "
                    f"{', '.join(repr(a) for a in allowed)}")


SLOT_STATE_SPECS = {
    "attn": SlotStateSpec("attn"),
    "moe": SlotStateSpec("moe", capacity_coupled=True),
    "local": SlotStateSpec("local", cache_unit="state", window_bound=True),
    "rwkv": SlotStateSpec("rwkv", advance="scan", cache_unit="state",
                          fold_state=True),
    "rec": SlotStateSpec("rec", advance="scan", cache_unit="state",
                         fold_state=True),
}


def slot_state_spec(kind: str) -> SlotStateSpec:
    """The :class:`SlotStateSpec` of one block kind (an allowed-vocabulary
    error for unknown kinds)."""
    if kind not in SLOT_STATE_SPECS:
        raise ValueError(
            f"slot_state_spec: unknown block kind {kind!r}; allowed: "
            f"{', '.join(repr(k) for k in ENGINE_KINDS)}")
    return SLOT_STATE_SPECS[kind]


def layer_kinds(cfg) -> Tuple[str, ...]:
    """Each layer's block kind: ``cfg.block_pattern`` cycled over the
    layers."""
    return tuple(cfg.layer_kind(i) for i in range(cfg.n_layers))


def slot_state_specs(cfg) -> Tuple[SlotStateSpec, ...]:
    """The distinct specs of ``cfg``'s layers, each kind validated."""
    return tuple(slot_state_spec(k) for k in dict.fromkeys(layer_kinds(cfg)))


def check_engine_kinds(cfg) -> Tuple[SlotStateSpec, ...]:
    """Validate every block kind of ``cfg`` against the protocol and return
    the specs (the engine calls this once at construction)."""
    return slot_state_specs(cfg)


def engine_capacity_coupled(cfg, tokens: int) -> bool:
    """True when serving ``cfg`` at batches of up to ``tokens`` tokens can
    couple co-batched requests through capacity-based MoE dispatch: some
    spec is ``capacity_coupled`` and the shape is not provably drop-free
    (:func:`repro_torch.models.moe.drop_free`)."""
    if not any(s.capacity_coupled for s in slot_state_specs(cfg)):
        return False
    return not drop_free(cfg, tokens)


def init_slot_state(cfg, kind: str, batch: int, max_len: int, *,
                    device=None) -> dict:
    """One block's zero slot state: K/V rows ``{"k", "v"}`` [batch,
    max_len, n_kv_heads, head_dim] for ``attn``/``moe`` (int8, with bf16
    ``k_scale`` / ``v_scale`` [batch, max_len, n_kv_heads, 1], under
    ``kv_cache_dtype="int8"``), a ring of
    ``min(local_window, max_len)`` slots for ``local``, the RWKV state
    ``{"s", "x_tmix", "x_cmix"}`` or the RG-LRU state ``{"h", "conv"}``."""
    slot_state_spec(kind)
    if kind in ("attn", "moe"):
        return init_kv_cache(cfg, batch, max_len, device=device)
    if kind == "local":
        return init_local_cache(cfg, batch, min(cfg.local_window, max_len),
                                device=device)
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device=device)
    return init_rglru_state(cfg, batch, device=device)


def init_slot_states(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """Zero slot states of every layer for ``batch`` slots of ``max_len``
    rows: ``{"layers": [per-layer state], "pos": [batch] int64 tensor,
    "pos_host": its host copy}``. The engine reads positions on the host
    (seeds fold them) and the layers on the card, so both are kept."""
    return {"layers": [init_slot_state(cfg, k, batch, max_len, device=device)
                       for k in layer_kinds(cfg)],
            "pos": torch.zeros(batch, dtype=torch.int64, device=device),
            "pos_host": np.zeros(batch, np.int64)}


def extract_state_chunk(cfg, caches, slot: int, pos: int,
                        length: int) -> dict:
    """One slot's state contribution of the chunk that prefilled rows
    [pos, pos + length), by each layer's ``cache_unit``: a copy of the K/V
    rows it wrote, an int8 cache's scales with them (``'rows'``: every leaf
    carries the position at axis 1), or of the whole post-chunk state
    (``'state'``: a ring, a fold), which :func:`inject_state_chunk` writes
    back."""
    check_engine_kinds(cfg)
    out = []
    for kind, state in zip(layer_kinds(cfg), caches["layers"]):
        if SLOT_STATE_SPECS[kind].cache_unit == "rows":
            out.append({n: t[slot, pos:pos + length].clone()
                        for n, t in state.items()})
        else:
            out.append({n: t[slot].clone() for n, t in state.items()})
    return {"layers": out}


def inject_state_chunk(cfg, caches, slot: int, pos: int, chunk) -> dict:
    """Write a state chunk of :func:`extract_state_chunk` into ``slot``, in
    place: rows back at [pos, pos + chunk length), a snapshot over the
    slot's whole state (injecting a trie path's chunks in order leaves the
    deepest snapshot standing, the state after that prefix). Injecting
    what a request prefilled for the same tokens (the same content-salted
    streams, the same image) leaves the slot as a cold prefill of the chunk
    would. The caller owns the slot's position."""
    check_engine_kinds(cfg)
    for kind, state, ch in zip(layer_kinds(cfg), caches["layers"],
                               chunk["layers"]):
        rows = SLOT_STATE_SPECS[kind].cache_unit == "rows"
        for n, t in state.items():
            if rows:
                t[slot, pos:pos + ch[n].shape[0]] = ch[n]
            else:
                t[slot] = ch[n]
    return caches


def forward(model: LM, params: Mapping, batch, *, unembed: bool = True,
            with_aux: bool = False):
    """The reference's ``lm.forward(params, cfg, batch)``: ``params`` is a
    ``{path: tensor}`` tree in the reference's layout (layer-stacked
    ``groups/blk0/...`` leaves, :func:`convert.flat_from_jax`) and replaces
    ``model``'s weights for this call only (views, no copies). Gradients
    flow to the tree's stacked leaves, so a training step has one gradient
    per reference leaf. ``batch`` is a token tensor or the reference's
    batch dict (:meth:`LM.forward`). Returns logits [B, S, V] (the
    final-normed hidden states with ``unembed=False``), and with
    ``with_aux`` also the MoE layers' summed aux loss (a 0-dim float32
    tensor, zero without a MoE layer): :func:`forward_blocks`."""
    out, aux = forward_blocks(model, params, batch, unembed=unembed)
    return (out, aux) if with_aux else out


def _no_gather(path: str, t: torch.Tensor, row=None,
               local_experts: bool = False):
    return t


def _units(cfg):
    """The remat units of the layer stack: one a pattern group (the
    reference's ``jax.checkpoint`` of ``apply_group``), then one a tail
    layer; each a list of (layer, reference prefix, row)."""
    pat, n_groups, tail = convert.group_kinds(cfg)
    slots = convert.layer_slots(cfg)
    units = [[(g * len(pat) + i,) + slots[g * len(pat) + i]
              for i in range(len(pat))] for g in range(n_groups)]
    base = n_groups * len(pat)
    return units + [[(base + j,) + slots[base + j]] for j in range(len(tail))]


def forward_blocks(model: LM, params: Mapping, batch, *, remat: bool = False,
                   gather=None, unembed: bool = True):
    """(logits, or the final-normed hidden states with ``unembed=False``;
    the MoE layers' summed aux) of a ``{path: tensor}`` tree in the
    reference's layout, layer group by layer group: :func:`forward`, and
    the training step's forward.

    ``gather(path, t, row=None, local_experts=False)`` turns the tensor a
    leaf holds (row ``row`` of a stacked leaf for a layer) into the tensor
    the layer
    computes with, at the moment the layer needs it: the identity on one
    device, the all-gather of this rank's block under ZeRO-3
    (:class:`repro_torch.training.zero3.LeafGather`), whose backward
    reduce-scatters the gradient. ``local_experts`` is True for a MoE
    layer that takes the all-to-all (:func:`moe_a2a.route`), which reads
    only this rank's experts. With ``remat`` each group of layers runs
    under ``torch.utils.checkpoint``: its gathered leaves and activations
    are not kept for the backward, which gathers and recomputes them
    (``RunConfig.remat``, the reference's ``jax.checkpoint`` of a group);
    the step is bitwise the same either way."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import moe_a2a
    cfg = model.cfg
    g = gather if gather is not None else _no_gather
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    reads_embed = not (cfg.modality == "audio_stub" and "embeds" in batch)
    x = model._embed_inputs(
        {"embed": g("embed", params["embed"]) if reads_embed else None},
        batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int64,
                             device=x.device)[None].expand(b, s)
    rows = {}

    def leaf(path, row):
        if row is None:
            return params[path]
        if path not in rows:
            rows[path] = params[path].unbind(0)
        return rows[path][row]

    def unit_args(unit):
        return [(layer, row, mod, name, f"{prefix}/{mod}/{name}")
                for layer, prefix, row in unit
                for mod, names in convert.block_leaves(
                    cfg, cfg.layer_kind(layer)).items() for name in names]

    def run(unit_leaves, layers, x, *ts):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        local = bool(cfg.n_experts) and moe_a2a.route(cfg, x.shape[0],
                                                      x.shape[1])
        over = {layer: {} for layer in layers}
        for (layer, row, mod, name, path), t in zip(unit_leaves, ts):
            over[layer].setdefault(mod, {})[name] = g(
                path, t, row=row,
                local_experts=local and name in EXPERT_LEAF_NAMES)
        for layer in layers:
            x, a, _ = model.blocks[layer].prefill(x, positions, over[layer])
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in _units(cfg):
        ul = unit_args(unit)
        ts = [leaf(path, row) for _, row, _, _, path in ul]
        fn = functools.partial(run, ul, [layer for layer, _, _ in unit])
        if remat:
            x, a = checkpoint(fn, x, *ts, use_reentrant=False)
        else:
            x, a = fn(x, *ts)
        aux = aux + a
    final = dict(model.final_norm.items())
    for name in final:
        final[name] = g(f"final_norm/{name}", params[f"final_norm/{name}"])
    x = model._final(x, final)
    if not unembed:
        return x, aux
    return x @ g("unembed", params["unembed"]).to(x.dtype), aux


def shell(cfg) -> LM:
    """An :class:`LM` whose weights are meta tensors (no storage): the module
    a training step runs a parameter tree through with :func:`forward`."""
    return LM(cfg, device="meta")


def param_count(params: Mapping) -> int:
    """Elements over the leaves of a ``{path: tensor}`` tree."""
    return sum(int(x.numel()) for x in params.values())
