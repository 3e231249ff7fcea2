"""The ambient device mesh and its combines (port of the mesh half of
``repro/distributed/sharding.py``).

A module-level "current mesh" (a ``torch.distributed`` ``DeviceMesh`` with
named dims, :mod:`repro_torch.launch.mesh`) keeps model code mesh-agnostic:
with no mesh set every query answers as for one device. The reference maps
logical tensor axes onto its mesh for GSPMD (``logical``, ``shard``,
``param_spec(s)``, ``sanitize_spec``); the port's mesh splits the SRAM
image and the batch only, by hand, so those wait for training on a mesh
(ROADMAP Queue 1 item 14b).

The combines below run on one mesh dim's process group: NCCL on the card,
gloo on the CPU. gloo wants contiguous tensors of dtypes it knows, so words
travel as int64 masked to 32 bits and values as float32.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_CURRENT_MESH = None
MODEL_AXIS = "model"       # the dim that splits and combines the SRAM image


def set_mesh(mesh) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    return _CURRENT_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the block; the previous one comes
    back on any exit."""
    prev = _CURRENT_MESH
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def axis_names(mesh=None) -> Tuple[str, ...]:
    mesh = mesh if mesh is not None else _CURRENT_MESH
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(name: str, mesh=None) -> int:
    """Ranks along ``name`` (1 without a mesh or without that dim)."""
    mesh = mesh if mesh is not None else _CURRENT_MESH
    names = axis_names(mesh)
    if name not in names:
        return 1
    return int(mesh.size(mesh_dim=names.index(name)))


def axis_index(name: str, mesh=None) -> int:
    """This rank's coordinate along ``name`` (0 without it)."""
    mesh = mesh if mesh is not None else _CURRENT_MESH
    if name not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(mesh_dim=name))


def model_axis() -> Optional[str]:
    return MODEL_AXIS if MODEL_AXIS in axis_names() else None


def batch_axes() -> Optional[Tuple[str, ...]]:
    got = tuple(a for a in ("pod", "data") if a in axis_names())
    return got if got else None


def _group(name: str, mesh):
    mesh = mesh if mesh is not None else _CURRENT_MESH
    return mesh.get_group(mesh_dim=name)


def all_gather_cat(t: torch.Tensor, name: str, mesh=None,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``name``, concatenated in rank order along
    ``dim`` (``t`` itself when the dim has one rank)."""
    n = axis_size(name, mesh)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=_group(name, mesh))
    return torch.cat(parts, dim=dim)


def all_reduce_sum(t: torch.Tensor, name: str, mesh=None) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``name`` (a new tensor)."""
    if axis_size(name, mesh) == 1:
        return t
    t = t.clone().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(name, mesh))
    return t


def sum_counts(counts: dict, name: str, mesh=None) -> dict:
    """Integer counters summed over ``name`` (ECC counts of sharded
    stores: each rank counts its own block)."""
    if axis_size(name, mesh) == 1:
        return dict(counts)
    keys = sorted(counts)
    dev = "cuda" if _device_type(mesh) == "cuda" else "cpu"
    t = torch.tensor([int(counts[k]) for k in keys], dtype=torch.int64,
                     device=dev)
    t = all_reduce_sum(t, name, mesh).cpu()
    return {k: int(v) for k, v in zip(keys, t.tolist())}


def all_gather_objects(obj, name: str, mesh=None) -> list:
    """Every rank's picklable ``obj`` along ``name``, in rank order."""
    n = axis_size(name, mesh)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=_group(name, mesh))
    return out


def _device_type(mesh=None) -> str:
    mesh = mesh if mesh is not None else _CURRENT_MESH
    return mesh.device_type if mesh is not None else "cpu"
