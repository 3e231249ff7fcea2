"""Decoder LM, ``attn`` block kind (port of ``repro/models/lm.py``).

The dense variants: rmsnorm, layernorm or OLMo's non-parametric norm; a
SwiGLU or GeLU MLP; GQA; text, or a ``vision_stub`` / ``audio_stub`` prefix
of precomputed embeddings.

The reference stacks the layers into scan groups ([L, ...] leaves); the port
holds one :class:`Block` module per layer. In the reference's layout the 2-D
leaves are ``embed`` [V, D], ``unembed`` [D, V] and the layer-stacked norm
parameters ``groups/blk0/norm{1,2}/{scale,bias}`` [L, D] (the block weights
are 3-D, the final norm 1-D), so those are the leaves a deployment packs
(:meth:`LM.cim_leaves`), AdamW decays and alignment aligns.

Serving reads the CIM leaves from a ``params`` dict (``{"embed",
"unembed"}`` -> tensor or :class:`~repro_torch.core.cim.CIMStore`, the
stacked norm leaves as tensors, plus an optional ``"_cim"``
dynamic-injection runtime) — what :meth:`CIMDeployment.serving_params`
returns (the hbm path decodes the norm leaves from their images). A CIMStore
embed is decoded row by row at gather time; a CIMStore unembed goes through
:func:`~repro_torch.core.deployment.dispatch_linear`, the fused kernel on the
card. Without ``params`` the module's own weights serve.

:meth:`LM.forward` returns full-sequence logits (the reference's
``lm.forward``, on a token tensor or the reference's batch dict);
:func:`forward` runs it on a parameter tree in the reference's layout, as
the sweep engine hands one to an ``eval_fn`` and as the training step
differentiates it (through a weightless :func:`shell`). Serving and the
engine are text-only, as the reference's.

The continuous-batching engine (:mod:`repro_torch.launch.engine`) speaks the
slot-state protocol: :class:`SlotStateSpec` per block kind,
:func:`init_slot_states`, :meth:`LM.prefill_chunk`, :meth:`LM.decode_slots`,
:func:`extract_state_chunk` and :func:`inject_state_chunk`. Only the ``attn``
kind is ported; the others wait (ROADMAP Queue 1 item 12.2).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.core import cim as cim_lib
from repro_torch.core import deployment as dep_lib
from repro_torch.core import tree
from repro_torch.device import resolve_device
from repro_torch.kernels.cim_read import ops as cr_ops
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.common import apply_norm, embed_init, init_norm
from repro_torch.models.mlp import MLP


def _norm(cfg, device) -> nn.ParameterDict:
    """One norm's parameters as a module (empty for ``nonparametric_ln``)."""
    return nn.ParameterDict({n: nn.Parameter(w) for n, w in init_norm(
        cfg.norm_type, cfg.d_model, device=device,
        dtype=cfg.pdtype()).items()})


class Block(nn.Module):
    """``attn`` kind: norm1 -> attention -> residual, norm2 -> MLP ->
    residual. The norms apply the ``(norm1, norm2)`` parameter mappings
    each call is handed (:meth:`LM._norms`: the block's own, or a serving
    dict's)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, generator=generator, device=device)
        self.mlp = MLP(cfg, generator=generator, device=device)
        self.norm1 = _norm(cfg, device)
        self.norm2 = _norm(cfg, device)

    def prefill(self, x, positions, norms):
        """-> (x, k, v) with k/v the layer's decode-cache rows."""
        n1, n2 = norms
        nt = self.cfg.norm_type
        out, k, v = self.attn.full(apply_norm(nt, n1, x), positions)
        x = x + out
        return x + self.mlp(apply_norm(nt, n2, x)), k, v

    def decode(self, x, cache, pos, norms):
        """Cache-append decode at ``pos`` (an int, or a [B] tensor of
        per-row positions)."""
        n1, n2 = norms
        nt = self.cfg.norm_type
        out, cache = self.attn.decode(apply_norm(nt, n1, x), cache, pos)
        x = x + out
        return x + self.mlp(apply_norm(nt, n2, x)), cache


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
    """Dense decoder: embed (or a stub prefix) -> Blocks -> final norm ->
    unembed. Built on ``device`` (default ``cuda``; pass ``"cpu"`` for the
    plain path)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if tuple(cfg.block_pattern) != ("attn",):
            raise NotImplementedError(
                f"{cfg.arch_id}: block pattern {tuple(cfg.block_pattern)} "
                f"{KINDS_WAIT}")
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
            [Block(cfg, generator=generator, device=device)
             for _ in range(cfg.n_layers)])
        self.final_norm = _norm(cfg, device)
        # The module's own weights serve inference only. Training
        # differentiates a reference-layout tree through :func:`forward`
        # (``functional_call``), which never reads these, so the flag does
        # not touch it.
        self.requires_grad_(False)

    def cim_leaves(self) -> dict:
        """The leaves the reference's deployment can pack, in flatten order:
        its 2-D float weights, ``embed``, ``unembed`` and the norms'
        layer-stacked parameters (a copy). The block weights are
        layer-stacked 3-D tensors there and the final norm's are 1-D."""
        return tree.flatten({"embed": self.embed.detach(),
                             "unembed": self.unembed.detach(),
                             **convert.stacked_norms(self)})

    def _params(self, params):
        p = {"embed": self.embed, "unembed": self.unembed}
        p.update(params or {})
        return p

    def _norms(self, params):
        """([(norm1, norm2)] a layer, the final norm's) parameter mappings:
        the module's own, each leaf replaced where ``params`` holds its
        reference-layout path (``groups/blk0/norm1/scale`` [L, D] row i;
        ``final_norm/scale``): the hbm path serves decoded norm leaves."""
        def pick(own, path, i=None):
            return {n: (w if f"{path}/{n}" not in params else
                        params[f"{path}/{n}"] if i is None else
                        params[f"{path}/{n}"][i]) for n, w in own.items()}
        layers = [(pick(blk.norm1, f"{convert.GROUP}/norm1", i),
                   pick(blk.norm2, f"{convert.GROUP}/norm2", i))
                  for i, blk in enumerate(self.blocks)]
        return layers, pick(self.final_norm, "final_norm")

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

    def forward(self, batch, params=None, *,
                unembed: bool = True) -> torch.Tensor:
        """``batch`` (tokens [B, S], or the reference's batch dict:
        ``tokens``, with ``vision_embeds`` [B, P, D] or ``embeds`` [B, S, D]
        for a stub modality) -> logits [B, S, V] at every position (no
        caches, reads at read index 0); with ``unembed=False`` the
        final-normed hidden states [B, S, D] that the unembed multiplies."""
        params = self._params(params)
        layers, final = self._norms(params)
        x = self._embed_inputs(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        for blk, norms in zip(self.blocks, layers):
            x = blk.prefill(x, positions, norms)[0]
        x = self._final(x, final)
        return _unembed_logits(params, x, pos=0) if unembed else x

    def prefill(self, tokens: torch.Tensor, params=None, max_len=None):
        """tokens [B, S] -> (last-token logits [B, V], caches). Caches hold
        ``max_len`` (default S) positions; reads happen at read index 0."""
        cfg = self.cfg
        params = self._params(params)
        norms, final = self._norms(params)
        x = _embed_lookup(params, cfg, tokens, pos=0)
        b, s, _ = x.shape
        max_len = max_len or s
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        layers = []
        for blk, nrm in zip(self.blocks, norms):
            x, k, v = blk.prefill(x, positions, nrm)
            cache = {"k": k.new_zeros((b, max_len) + k.shape[2:]),
                     "v": v.new_zeros((b, max_len) + v.shape[2:])}
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            layers.append(cache)
        x = self._final(x[:, -1:], final)
        logits = _unembed_logits(params, x, pos=0)[:, 0]
        return logits, {"layers": layers, "pos": s}

    def decode(self, caches, tokens: torch.Tensor, params=None):
        """One decode step at read index ``caches['pos']``. tokens [B, 1] ->
        (logits [B, V], caches); the caches update in place."""
        params = self._params(params)
        norms, final = self._norms(params)
        pos = caches["pos"]
        x = _embed_lookup(params, self.cfg, tokens, pos=pos)
        for blk, cache, nrm in zip(self.blocks, caches["layers"], norms):
            x, _ = blk.decode(x, cache, pos, nrm)
        x = self._final(x, final)
        logits = _unembed_logits(params, x, pos=pos)[:, 0]
        return logits, {"layers": caches["layers"], "pos": pos + 1}

    # ---------------------------------------------- continuous batching

    def prefill_chunk(self, caches, tokens: torch.Tensor, slot: int,
                      pos: int, length: Optional[int] = None,
                      req_salt: Optional[int] = None, params=None):
        """Chunked prefill of ONE slot of the engine's slot states
        (:func:`init_slot_states`): ``tokens`` [C] is one prompt chunk whose
        first ``length`` entries are valid (the ragged tail is padding whose
        K/V rows the causal mask hides until later writes overwrite them),
        appended to slot ``slot`` at rows [pos, pos + C). The chunk reads the
        CIM image once, at read index ``pos`` with the request salt
        ``req_salt``. Returns the last valid token's logits [V]; the slot's
        position becomes ``pos + length``."""
        cfg = self.cfg
        check_engine_kinds(cfg)
        c = tokens.shape[0]
        length = c if length is None else int(length)
        max_len = caches["layers"][0]["k"].shape[1]
        if not 1 <= length <= c or pos < 0 or pos + c > max_len:
            raise ValueError(f"prefill_chunk: rows [{pos}, {pos + c}) with "
                             f"{length} valid do not fit the {max_len}-row "
                             f"slot state")
        params = self._params(params)
        norms, final = self._norms(params)
        x = _embed_lookup(params, cfg, tokens[None], pos=pos,
                          req_salt=req_salt)
        for blk, cache, nrm in zip(self.blocks, caches["layers"], norms):
            view = {"k": cache["k"][slot:slot + 1],
                    "v": cache["v"][slot:slot + 1]}
            x, _ = blk.decode(x, view, pos, nrm)
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
        Inactive slots' positions do not advance; their stale K/V writes
        stay causally masked. Returns (logits [S, V], caches)."""
        cfg = self.cfg
        check_engine_kinds(cfg)
        dynamic = params is not None and params.get("_cim") is not None
        if dynamic and req_salts is None:
            raise ValueError(
                "decode_slots: params carry a dynamic-injection '_cim' "
                "runtime but no req_salts; per-read seeds would alias across "
                "requests: pass deployment.request_salt(rid) per slot")
        params = self._params(params)
        norms, final = self._norms(params)
        pos_host = caches["pos_host"]
        max_len = caches["layers"][0]["k"].shape[1]
        if (pos_host >= max_len).any():
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
        for blk, cache, nrm in zip(self.blocks, caches["layers"], norms):
            x, _ = blk.decode(x, cache, caches["pos"], nrm)
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
KINDS_WAIT = "waits (ROADMAP Queue 1 item 12.2); only 'attn' is ported"

_SPEC_VOCAB = {"kind": ENGINE_KINDS,
               "advance": ("parallel",),
               "cache_unit": ("rows",)}


@dataclasses.dataclass(frozen=True)
class SlotStateSpec:
    """Per-block-kind contract of the serving engine's slot-state protocol,
    reduced to what ``attn`` uses (the other kinds bring their fields with
    ROADMAP Queue 1 item 12.2).

    * ``advance``: how a prompt chunk enters the state, ``'parallel'``
      (position-parallel attention over K/V rows).
    * ``cache_unit``: the prefix cache's unit of reuse, ``'rows'`` (a chunk
      extracts and injects the rows it wrote).

    Unknown vocabulary fails at construction."""
    kind: str
    advance: str = "parallel"
    cache_unit: str = "rows"

    def __post_init__(self):
        for field, allowed in _SPEC_VOCAB.items():
            got = getattr(self, field)
            if got not in allowed:
                raise ValueError(
                    f"SlotStateSpec.{field}: unknown value {got!r}; allowed: "
                    f"{', '.join(repr(a) for a in allowed)}")


SLOT_STATE_SPECS = {"attn": SlotStateSpec("attn")}


def slot_state_spec(kind: str) -> SlotStateSpec:
    """The :class:`SlotStateSpec` of one block kind: an allowed-vocabulary
    error for unknown kinds, NotImplementedError for the reference's kinds
    the port does not serve yet."""
    if kind not in ENGINE_KINDS:
        raise ValueError(
            f"slot_state_spec: unknown block kind {kind!r}; allowed: "
            f"{', '.join(repr(k) for k in ENGINE_KINDS)}")
    if kind not in SLOT_STATE_SPECS:
        raise NotImplementedError(f"slot-state kind {kind!r} {KINDS_WAIT}")
    return SLOT_STATE_SPECS[kind]


def layer_kinds(cfg) -> Tuple[str, ...]:
    """Each layer's block kind: ``cfg.block_pattern`` cycled over the
    layers."""
    pat = tuple(cfg.block_pattern)
    return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))


def slot_state_specs(cfg) -> Tuple[SlotStateSpec, ...]:
    """The distinct specs of ``cfg``'s layers, each kind validated."""
    return tuple(slot_state_spec(k) for k in dict.fromkeys(layer_kinds(cfg)))


def check_engine_kinds(cfg) -> Tuple[SlotStateSpec, ...]:
    """Validate every block kind of ``cfg`` against the protocol and return
    the specs (the engine calls this once at construction)."""
    return slot_state_specs(cfg)


def engine_capacity_coupled(cfg, tokens: int) -> bool:
    """True when co-batched requests of up to ``tokens`` tokens can couple
    through capacity-based MoE dispatch, which voids the bitwise
    solo-vs-co-batched guarantee. Only ``moe`` is capacity-coupled, and it
    waits with ``moe.drop_free`` (ROADMAP Queue 1 item 12.2), so every kind
    that validates here is uncoupled."""
    del tokens     # the drop-free test of moe's capacity comes with moe
    slot_state_specs(cfg)
    return False


def init_slot_state(cfg, kind: str, batch: int, max_len: int, *,
                    device=None) -> dict:
    """One block's zero slot state: K/V rows ``{"k", "v"}`` [batch,
    max_len, n_kv_heads, head_dim] for ``attn``."""
    slot_state_spec(kind)
    return init_kv_cache(cfg, batch, max_len, device=device)


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
    [pos, pos + length) (``cache_unit='rows'``): a copy of those K/V rows
    of every layer, which :func:`inject_state_chunk` writes back."""
    check_engine_kinds(cfg)
    return {"layers": [{n: c[n][slot, pos:pos + length].clone()
                        for n in ("k", "v")} for c in caches["layers"]]}


def inject_state_chunk(cfg, caches, slot: int, pos: int, chunk) -> dict:
    """Write a state chunk of :func:`extract_state_chunk` into ``slot`` at
    rows [pos, pos + chunk length), in place. Injecting what a request
    prefilled for the same tokens (the same content-salted streams, the
    same image) leaves the slot as a cold prefill of the chunk would. The
    caller owns the slot's position."""
    check_engine_kinds(cfg)
    for c, ch in zip(caches["layers"], chunk["layers"]):
        for n in ("k", "v"):
            c[n][slot, pos:pos + ch[n].shape[0]] = ch[n]
    return caches


def forward(model: LM, params: Mapping, batch, *,
            unembed: bool = True) -> torch.Tensor:
    """The reference's ``lm.forward(params, cfg, batch)``: ``params`` is a
    ``{path: tensor}`` tree in the reference's layout (layer-stacked
    ``groups/blk0/...`` leaves, :func:`convert.flat_from_jax`) and replaces
    ``model``'s weights for this call only (views, no copies). Gradients
    flow to the tree's stacked leaves, so a training step has one gradient
    per reference leaf. ``batch`` is a token tensor or the reference's
    batch dict (:meth:`LM.forward`). Returns logits [B, S, V] (the
    final-normed hidden states with ``unembed=False``)."""
    state = convert.lm_state_from_flat(params, model.cfg)
    return torch.func.functional_call(model, state, (batch,),
                                      {"unembed": unembed})


def shell(cfg) -> LM:
    """An :class:`LM` whose weights are meta tensors (no storage): the module
    a training step runs a parameter tree through with :func:`forward`."""
    return LM(cfg, device="meta")


def param_count(params: Mapping) -> int:
    """Elements over the leaves of a ``{path: tensor}`` tree."""
    return sum(int(x.numel()) for x in params.values())
