"""Carry weights and packed images across from the reference package, and
between the port's two parameter layouts.

The ``*_from_jax`` functions take numpy arrays (what ``np.asarray`` makes of
the reference's jax arrays), so this module needs neither jax nor ``repro``.
The reference's layout is a ``{path: tensor}`` tree in flatten order
(:mod:`repro_torch.core.tree`) with the layers stacked under
``groups/blk0``; :class:`repro_torch.models.lm.LM` holds one ``blocks.<i>``
module per layer.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.cim import CIMConfig, CIMStore
from repro_torch.models.common import NORM_LEAVES
from repro_torch.models.mlp import MLP_LEAVES

GROUP = "groups/blk0"
ATTN_LEAVES = ("wk", "wo", "wq", "wv")


def block_leaves(cfg) -> dict:
    """{module: leaf names} of one ``attn`` block: the attention weights,
    the MLP's by ``mlp_type`` and the two norms' by ``norm_type``."""
    norm = NORM_LEAVES[cfg.norm_type]
    return {"attn": ATTN_LEAVES, "mlp": MLP_LEAVES[cfg.mlp_type],
            "norm1": norm, "norm2": norm}


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


def _check_attn(cfg) -> None:
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError("only the 'attn' block kind is ported "
                                  "(ROADMAP Queue 1 item 12.2)")


def lm_state_from_flat(flat: Mapping, cfg) -> dict:
    """Reference-layout LM params -> a state dict of
    :class:`repro_torch.models.lm.LM`: each ``groups/blk0/...`` leaf unstacks
    into ``blocks.<i>...`` views (no copies), ``final_norm/<name>`` maps to
    ``final_norm.<name>``."""
    _check_attn(cfg)
    state = {"embed": flat["embed"], "unembed": flat["unembed"]}
    for mod, names in block_leaves(cfg).items():
        for name in names:
            for i, w in enumerate(flat[f"{GROUP}/{mod}/{name}"].unbind(0)):
                state[f"blocks.{i}.{mod}.{name}"] = w
    for name in block_leaves(cfg)["norm1"]:
        state[f"final_norm.{name}"] = flat[f"final_norm/{name}"]
    return state


def _stack(model, mod: str, name: str) -> torch.Tensor:
    return torch.stack([getattr(getattr(blk, mod), name).detach()
                        for blk in model.blocks])


def stacked_norms(model) -> dict:
    """An :class:`LM`'s block norm parameters in the reference layout:
    ``groups/blk0/norm{1,2}/<name>`` [L, D] (a copy; empty for
    ``nonparametric_ln``)."""
    return {f"{GROUP}/{mod}/{name}": _stack(model, mod, name)
            for mod in ("norm1", "norm2")
            for name in block_leaves(model.cfg)[mod]}


def flat_from_lm(model) -> dict:
    """An :class:`LM`'s weights -> the reference layout (the block weights
    are stacked, a copy)."""
    _check_attn(model.cfg)
    flat = {"embed": model.embed.detach(), "unembed": model.unembed.detach()}
    for mod, names in block_leaves(model.cfg).items():
        for name in names:
            flat[f"{GROUP}/{mod}/{name}"] = _stack(model, mod, name)
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
