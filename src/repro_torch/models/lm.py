"""Decoder LM, ``attn`` block kind (port of ``repro/models/lm.py``).

The reference stacks the layers into scan groups ([L, ...] leaves); the port
holds one :class:`Block` module per layer. Only ``embed`` [V, D] and
``unembed`` [D, V] are 2-D in the reference's layout, so they are the only
leaves a deployment packs (:meth:`LM.cim_leaves`).

Serving reads the two CIM leaves from a ``params`` dict (``{"embed",
"unembed"}`` -> tensor or :class:`~repro_torch.core.cim.CIMStore`, plus an
optional ``"_cim"`` dynamic-injection runtime) — what
:meth:`CIMDeployment.serving_params` returns. A CIMStore embed is decoded row
by row at gather time; a CIMStore unembed goes through
:func:`~repro_torch.core.deployment.dispatch_linear`, the fused kernel on the
card. Without ``params`` the module's own weights serve.

:meth:`LM.forward` returns full-sequence logits (the reference's
``lm.forward``); :func:`forward` runs it on a parameter tree in the
reference's layout, as the sweep engine hands one to an ``eval_fn`` and as
the training step differentiates it (through a weightless :func:`shell`).

The continuous-batching slot-state API waits (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch import convert
from repro_torch.core import cim as cim_lib
from repro_torch.core import deployment as dep_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.cim_read import ops as cr_ops
from repro_torch.models.attention import Attention
from repro_torch.models.common import apply_norm, embed_init
from repro_torch.models.mlp import MLP


class Block(nn.Module):
    """``attn`` kind: norm -> attention -> residual, norm -> MLP -> residual."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.norm_type != "nonparametric_ln":
            raise NotImplementedError(
                f"norm_type={cfg.norm_type!r} waits (ROADMAP Queue 1 item 12)")
        self.cfg = cfg
        self.attn = Attention(cfg, generator=generator, device=device)
        self.mlp = MLP(cfg, generator=generator, device=device)

    def norm(self, x):
        return apply_norm(self.cfg.norm_type, {}, x)

    def prefill(self, x, positions):
        """-> (x, k, v) with k/v the layer's decode-cache rows."""
        out, k, v = self.attn.full(self.norm(x), positions)
        x = x + out
        return x + self.mlp(self.norm(x)), k, v

    def decode(self, x, cache, pos: int):
        out, cache = self.attn.decode(self.norm(x), cache, pos)
        x = x + out
        return x + self.mlp(self.norm(x)), cache


def _cim_read_state(params, pos: int, leaf: str):
    """(per-plane seeds, thr_man, thr_meta, model) of one CIM read, or
    (None, 0, 0, None) when no ``_cim`` runtime rides in ``params`` (static
    reads). Seeds fold per leaf and read index ``pos`` (the per-request
    salt of the engine waits with the engine). A fault model in the runtime
    shapes the streams: drift keys its tick on ``pos``, folded into the
    thresholds returned here, so the model handed on carries tick 0."""
    rt = params.get("_cim")
    if rt is None:
        return None, 0, 0, None
    seeds = dep_lib.request_read_seeds(rt["seeds"], dep_lib.leaf_salt(leaf),
                                       None, pos)
    return (seeds,) + dep_lib.read_thresholds(rt, pos)


def _embed_lookup(params, cfg, tokens, pos: int = 0):
    """Token embedding gather; a CIMStore leaf decodes only the gathered rows
    (:func:`dispatch_read_rows`)."""
    emb = params["embed"]
    if isinstance(emb, cim_lib.CIMStore):
        seeds, tm, tt, model = _cim_read_state(params, pos, "embed")
        rows = dep_lib.dispatch_read_rows(emb, tokens, seeds=seeds,
                                          thr_man=tm, thr_meta=tt, model=model)
        return rows.to(cfg.cdtype())
    return emb.to(cfg.cdtype())[tokens]


def _unembed_logits(params, x, pos: int = 0):
    """Final projection; a CIMStore leaf routes through
    :func:`dispatch_linear` (the fused decode-on-read kernel on the card)."""
    w_un = params["unembed"]
    if isinstance(w_un, cim_lib.CIMStore):
        seeds, tm, tt, model = _cim_read_state(params, pos, "unembed")
        scalars = cr_ops.make_scalars(seeds, tm, tt, model=model) \
            if seeds is not None else None
        return dep_lib.dispatch_linear(x, w_un, scalars=scalars, model=model)
    return x @ w_un.to(x.dtype)


class LM(nn.Module):
    """olmo-family decoder: embed -> Blocks -> final norm -> unembed. Built on
    ``device`` (default ``cuda``; pass ``"cpu"`` for the plain path)."""

    def __init__(self, cfg, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if tuple(cfg.block_pattern) != ("attn",) or cfg.modality != "text":
            raise NotImplementedError(
                f"{cfg.arch_id}: only the text 'attn' block kind is ported "
                f"(ROADMAP Queue 1 item 12)")
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
        # The module's own weights serve inference only. Training
        # differentiates a reference-layout tree through :func:`forward`
        # (``functional_call``), which never reads these, so the flag does
        # not touch it.
        self.requires_grad_(False)

    def cim_leaves(self) -> dict:
        """The leaves the reference's deployment can pack: its only 2-D
        weights (the block weights are layer-stacked 3-D tensors there)."""
        return {"embed": self.embed.detach(), "unembed": self.unembed.detach()}

    def _params(self, params):
        p = {"embed": self.embed, "unembed": self.unembed}
        p.update(params or {})
        return p

    def _final(self, x):
        return apply_norm(self.cfg.norm_type, {}, x)

    def forward(self, tokens: torch.Tensor, params=None, *,
                unembed: bool = True) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] at every position (no caches,
        reads at read index 0); with ``unembed=False`` the final-normed
        hidden states [B, S, D] that the unembed multiplies."""
        params = self._params(params)
        x = _embed_lookup(params, self.cfg, tokens, pos=0)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        for blk in self.blocks:
            x = blk.prefill(x, positions)[0]
        x = self._final(x)
        return _unembed_logits(params, x, pos=0) if unembed else x

    def prefill(self, tokens: torch.Tensor, params=None, max_len=None):
        """tokens [B, S] -> (last-token logits [B, V], caches). Caches hold
        ``max_len`` (default S) positions; reads happen at read index 0."""
        cfg = self.cfg
        params = self._params(params)
        x = _embed_lookup(params, cfg, tokens, pos=0)
        b, s, _ = x.shape
        max_len = max_len or s
        positions = torch.arange(s, dtype=torch.int64,
                                 device=x.device)[None].expand(b, s)
        layers = []
        for blk in self.blocks:
            x, k, v = blk.prefill(x, positions)
            cache = {"k": k.new_zeros((b, max_len) + k.shape[2:]),
                     "v": v.new_zeros((b, max_len) + v.shape[2:])}
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            layers.append(cache)
        x = self._final(x[:, -1:])
        logits = _unembed_logits(params, x, pos=0)[:, 0]
        return logits, {"layers": layers, "pos": s}

    def decode(self, caches, tokens: torch.Tensor, params=None):
        """One decode step at read index ``caches['pos']``. tokens [B, 1] ->
        (logits [B, V], caches); the caches update in place."""
        params = self._params(params)
        pos = caches["pos"]
        x = _embed_lookup(params, self.cfg, tokens, pos=pos)
        for blk, cache in zip(self.blocks, caches["layers"]):
            x, _ = blk.decode(x, cache, pos)
        x = self._final(x)
        logits = _unembed_logits(params, x, pos=pos)[:, 0]
        return logits, {"layers": caches["layers"], "pos": pos + 1}


def forward(model: LM, params: Mapping, tokens: torch.Tensor, *,
            unembed: bool = True) -> torch.Tensor:
    """The reference's ``lm.forward(params, cfg, batch)``: ``params`` is a
    ``{path: tensor}`` tree in the reference's layout (layer-stacked
    ``groups/blk0/...`` leaves, :func:`convert.flat_from_jax`) and replaces
    ``model``'s weights for this call only (views, no copies). Gradients
    flow to the tree's stacked leaves, so a training step has one gradient
    per reference leaf. Returns logits [B, S, V] (the final-normed hidden
    states with ``unembed=False``)."""
    state = convert.lm_state_from_flat(params, model.cfg)
    return torch.func.functional_call(model, state, (tokens,),
                                      {"unembed": unembed})


def shell(cfg) -> LM:
    """An :class:`LM` whose weights are meta tensors (no storage): the module
    a training step runs a parameter tree through with :func:`forward`."""
    return LM(cfg, device="meta")


def param_count(params: Mapping) -> int:
    """Elements over the leaves of a ``{path: tensor}`` tree."""
    return sum(int(x.numel()) for x in params.values())
