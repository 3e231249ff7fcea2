"""Carry weights and packed images across from the reference package.

Both functions take numpy arrays (what ``np.asarray`` makes of the
reference's jax arrays), so this module needs neither jax nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cim import CIMConfig, CIMStore


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)        # uint32 words live in int32 views
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_params: dict, cfg, device="cpu") -> dict:
    """The reference's olmo params pytree (numpy leaves) -> a state dict of
    :class:`repro_torch.models.lm.LM`.

    The reference scan-stacks the layers under ``groups/blk0`` with a leading
    layer axis; each slice becomes one ``blocks.<i>`` module here."""
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError("only the 'attn' block kind is ported")
    grp = np_params["groups"]["blk0"]
    state = {"embed": _tensor(np_params["embed"], device),
             "unembed": _tensor(np_params["unembed"], device)}
    for i in range(cfg.n_layers):
        for mod in ("attn", "mlp"):
            for name, leaf in grp[mod].items():
                state[f"blocks.{i}.{mod}.{name}"] = _tensor(np.asarray(leaf)[i],
                                                           device)
    return state


def store_from_numpy(planes: dict, shape, cfg: CIMConfig,
                     device="cpu") -> CIMStore:
    """A reference CIMStore's planes (numpy ``man``/``sign``/``exp``/
    ``codewords``, ``None`` where absent) -> the port's store, bit for bit."""
    def get(name):
        a = planes.get(name)
        return None if a is None else _tensor(np.asarray(a), device)
    return CIMStore(man=get("man"), sign=get("sign"), exp=get("exp"),
                    codewords=get("codewords"), shape=tuple(shape), cfg=cfg)
