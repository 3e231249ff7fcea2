"""Carry weights and packed images across from the reference package, and
between the port's two parameter layouts.

The ``*_from_jax`` functions take numpy arrays (what ``np.asarray`` makes of
the reference's jax arrays), so this module needs neither jax nor ``repro``.
The reference's layout is a ``{path: tensor}`` tree in flatten order
(:mod:`repro_torch.core.tree`) with the layers stacked in pattern groups
under ``groups/blk{i}`` and the remainder unstacked under ``tail/{j}``;
:class:`repro_torch.models.lm.LM` holds one ``blocks.<l>`` module per layer
(:func:`layer_slots`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.cim import CIMConfig, CIMStore
from repro_torch.models.common import NORM_LEAVES
from repro_torch.models.mlp import MLP_LEAVES
from repro_torch.models.moe import EXPERT_LEAF_NAMES, MOE_LEAVES

ATTN_LEAVES = ("wk", "wo", "wq", "wv")
TMIX_LEAVES = ("bonus_u", "decay_lora_a", "decay_lora_b", "decay_w0",
               "gn_scale", "ts_lora_a", "ts_lora_b", "ts_mu", "ts_mu0", "w_g",
               "w_k", "w_o", "w_r", "w_v")
REC_LEAVES = ("conv_b", "conv_w", "rg_ba", "rg_bi", "rg_lambda", "rg_wa",
              "rg_wi", "w_down", "w_gate_br", "w_x")


def block_leaves(cfg, kind: str = "attn") -> dict:
    """{module: leaf names} of one block of ``kind``: its mixer's (attention,
    RWKV's time mix, the RG-LRU block), its FFN's (the MLP by
    ``mlp_type``, the MoE, RWKV's channel mix) and the two norms' by
    ``norm_type``."""
    norm = NORM_LEAVES[cfg.norm_type]
    mods = {"attn": {"attn": ATTN_LEAVES, "mlp": MLP_LEAVES[cfg.mlp_type]},
            "moe": {"attn": ATTN_LEAVES, "moe": MOE_LEAVES},
            "rwkv": {"tmix": TMIX_LEAVES, "cmix": MLP_LEAVES[cfg.mlp_type]},
            "rec": {"rec": REC_LEAVES, "mlp": MLP_LEAVES[cfg.mlp_type]}}
    mods["local"] = mods["attn"]
    if kind not in mods:
        raise ValueError(f"block kind {kind!r}")
    return {**mods[kind], "norm1": norm, "norm2": norm}


def group_kinds(cfg):
    """The reference's layout of ``cfg``'s layers: (pattern, number of
    stacked groups, the tail's kinds)."""
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, pat[:cfg.n_layers % len(pat)]


def layer_slots(cfg) -> list:
    """[(reference prefix, row)] a layer, in layer order: group g's
    position i is layer ``g * len(pattern) + i`` at row g of the stacked
    ``groups/blk{i}`` leaves; tail block j follows the groups, unstacked
    at ``tail/{j}`` (row None)."""
    pat, n_groups, tail = group_kinds(cfg)
    return [(f"groups/blk{i}", g) for g in range(n_groups)
            for i in range(len(pat))] + \
        [(f"tail/{j}", None) for j in range(len(tail))]


def _layer_leaves(cfg):
    """(layer, reference prefix, row, module, leaf name) of every block
    leaf."""
    for layer, (prefix, row) in enumerate(layer_slots(cfg)):
        for mod, names in block_leaves(cfg, cfg.layer_kind(layer)).items():
            for name in names:
                yield layer, prefix, row, mod, name


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)        # uint32 words live in int32 views
    return torch.from_numpy(a.copy()).to(device)


def flat_from_jax(np_params: Mapping, device="cpu") -> dict:
    """The reference's params pytree (numpy leaves) -> ``{path: tensor}`` in
    its flatten order, stacked shapes kept (the sweep engine's input)."""
    return {p: _tensor(np.asarray(a), device)
            for p, a in tree.flatten(np_params).items()}


def cnn_params_from_jax(np_params: Mapping, device="cpu") -> dict:
    """The reference's ``init_cnn`` params -> the port's CNN params (HWIO
    conv kernels, unchanged)."""
    flat = flat_from_jax(np_params, device)
    if set(flat) != {"conv1", "conv2", "dense", "head"}:
        raise ValueError(f"not CNN params: {sorted(flat)}")
    return flat


def lm_state_from_flat(flat: Mapping, cfg) -> dict:
    """Reference-layout LM params -> a state dict of
    :class:`repro_torch.models.lm.LM`: each stacked ``groups/blk{i}/...``
    leaf unstacks into its layers' ``blocks.<l>...`` views and each
    ``tail/{j}/...`` leaf maps to its layer (no copies);
    ``final_norm/<name>`` maps to ``final_norm.<name>``."""
    state = {"embed": flat["embed"], "unembed": flat["unembed"]}
    for layer, prefix, row, mod, name in _layer_leaves(cfg):
        w = flat[f"{prefix}/{mod}/{name}"]
        state[f"blocks.{layer}.{mod}.{name}"] = w if row is None else w[row]
    for name in NORM_LEAVES[cfg.norm_type]:
        state[f"final_norm.{name}"] = flat[f"final_norm/{name}"]
    return state


def _ref_leaves(model, keep=None) -> dict:
    """An :class:`LM`'s block leaves in the reference layout (group leaves
    stacked, a copy; tail leaves as they are), those ``keep(leaf name,
    per-layer ndim, row)`` admits."""
    by_path = {}
    for layer, prefix, row, mod, name in _layer_leaves(model.cfg):
        w = getattr(getattr(model.blocks[layer], mod), name).detach()
        if keep is None or keep(name, w.ndim, row):
            by_path.setdefault(f"{prefix}/{mod}/{name}", []).append(
                (row, w))
    return {p: ws[0][1] if ws[0][0] is None
            else torch.stack([w for _, w in ws]) for p, ws in by_path.items()}


def two_d_leaves(model) -> dict:
    """The 2-D float leaves of an :class:`LM` in the reference's layout and
    flatten order, the leaves its deployment can pack: ``embed``,
    ``unembed``, the group leaves that are 1-D a layer (stacked [G, d], a
    copy) and the tail's 2-D leaves. The block matrices are 3-D stacked
    there and the final norm's leaves 1-D."""
    flat = {"embed": model.embed.detach(), "unembed": model.unembed.detach()}
    flat.update(_ref_leaves(model, lambda name, ndim, row:
                            ndim + (row is not None) == 2))
    return tree.flatten(flat)


def expert_leaves(model) -> dict:
    """An :class:`LM`'s stacked MoE expert weights in the reference layout
    (``groups/blk{i}/moe/moe_win`` [G, E, D, F] and the like, a copy; an
    :class:`~repro_torch.core.deployment.ExpertDeployment`'s input)."""
    return tree.flatten(_ref_leaves(model, lambda name, ndim, row:
                                    name in EXPERT_LEAF_NAMES))


def flat_from_lm(model) -> dict:
    """An :class:`LM`'s weights -> the reference layout (the group leaves
    stacked, a copy)."""
    flat = {"embed": model.embed.detach(), "unembed": model.unembed.detach(),
            **_ref_leaves(model)}
    for name, w in model.final_norm.items():
        flat[f"final_norm/{name}"] = w.detach()
    return tree.flatten(flat)


def params_from_jax(np_params: Mapping, cfg, device="cpu") -> dict:
    """The reference's LM params pytree (numpy leaves) -> a state dict of
    :class:`repro_torch.models.lm.LM`."""
    return lm_state_from_flat(flat_from_jax(np_params, device), cfg)


def store_from_numpy(planes: dict, shape, cfg: CIMConfig,
                     device="cpu") -> CIMStore:
    """A reference CIMStore's planes (numpy ``man``/``sign``/``exp``/
    ``codewords``, ``None`` where absent) -> the port's store, bit for bit."""
    def get(name):
        a = planes.get(name)
        return None if a is None else _tensor(np.asarray(a), device)
    return CIMStore(man=get("man"), sign=get("sign"), exp=get("exp"),
                    codewords=get("codewords"), shape=tuple(shape), cfg=cfg)


def train_state_from_jax(state, device="cpu"):
    """The reference's ``TrainState`` (jax or numpy leaves) -> the port's
    :class:`~repro_torch.training.steps.TrainState`: params, the frozen
    ``exps`` and ``signs`` (``None`` leaves kept, keyed by the params'
    paths), the AdamW ``m`` / ``v`` / ``step`` and, where the state has
    them, the gradient-compression residuals ``ef_error``, all carried as
    numpy, so both packages can start from one state."""
    from repro_torch.training.steps import TrainState
    params = flat_from_jax(state.params, device)

    def keyed(t) -> dict:
        flat = tree.flatten(t, keep_none=True)
        if set(flat) != set(params):
            raise ValueError(f"tree paths {sorted(flat)} != params paths "
                             f"{sorted(params)}")
        return {p: None if flat[p] is None
                else _tensor(np.asarray(flat[p]), device) for p in params}

    opt = {"m": keyed(state.opt["m"]), "v": keyed(state.opt["v"]),
           "step": torch.tensor(int(np.asarray(state.opt["step"])),
                                dtype=torch.int32)}
    ef = getattr(state, "ef_error", None)
    return TrainState(params=params, opt=opt, exps=keyed(state.exps),
                      signs=keyed(state.signs),
                      ef_error=None if ef is None else keyed(ef))
