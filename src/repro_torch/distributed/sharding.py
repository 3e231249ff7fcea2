"""The ambient device mesh and its combines (port of the mesh half of
``repro/distributed/sharding.py``).

A module-level "current mesh" (a ``torch.distributed`` ``DeviceMesh`` with
named dims, :mod:`repro_torch.launch.mesh`) keeps model code mesh-agnostic:
with no mesh set every query answers as for one device. A second ambient
setting, :func:`split_rows`, says that activations hold only this rank's
rows of the batch (data parallelism: the training step and the mesh serve
keep their data rank's rows when the batch axes divide the batch), so a
layer that needs the global batch (the MoE's dense dispatch) gathers it.
The reference maps logical tensor axes onto its mesh for GSPMD
(``logical``, ``shard``, ``param_spec(s)``, ``sanitize_spec``); the port's
mesh splits the SRAM image, the batch and the MoE's experts only, by hand,
so those wait for sharded training state (ROADMAP Queue 1 item 14b-1b).

The combines below run on one mesh dim's process group: NCCL on the card,
gloo on the CPU. gloo wants contiguous tensors of dtypes it knows, so words
travel as int64 masked to 32 bits and values as float32. The exchanges
that a differentiated forward crosses (:func:`all_to_all`,
:func:`all_gather`) carry their backward: the reverse exchange, and the sum
of every rank's gradient back to the owner of each block. Each has an
in-process form (:func:`all_to_all_local`, :func:`all_gather_local`) over a
list of per-rank tensors, with which one process emulates the ranks.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_CURRENT_MESH = None
_ROWS_MESH = None          # the mesh whose batch axes split the activations
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


@contextlib.contextmanager
def split_rows(mesh):
    """Within the block, activations hold this rank's rows of the batch,
    split over ``mesh``'s batch axes (:func:`batch_rows`); ``None`` means
    every rank holds the whole batch. The previous setting comes back on
    any exit."""
    global _ROWS_MESH
    prev = _ROWS_MESH
    _ROWS_MESH = mesh
    try:
        yield mesh
    finally:
        _ROWS_MESH = prev


def rows_mesh():
    """The mesh of the enclosing :func:`split_rows`, or None."""
    return _ROWS_MESH


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


def batch_axes(mesh=None) -> Optional[Tuple[str, ...]]:
    got = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return got if got else None


def batch_ranks(mesh=None) -> int:
    """Ranks over the batch axes (their product; 1 without them)."""
    n = 1
    for a in batch_axes(mesh) or ():
        n *= axis_size(a, mesh)
    return n


def batch_rows(batch: int, mesh=None) -> slice:
    """This rank's rows of a ``batch``-row global batch: its block over the
    batch axes when they divide ``batch`` (the reference's data-parallel
    placement), else every row (the batch replicated)."""
    n = batch_ranks(mesh)
    if n == 1 or batch % n:
        return slice(None)
    index = 0
    for a in batch_axes(mesh):
        index = index * axis_size(a, mesh) + axis_index(a, mesh)
    per = batch // n
    return slice(index * per, (index + 1) * per)


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


def all_reduce_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``t`` over the whole mesh (its size is the
    world's, :mod:`repro_torch.launch.mesh`), in place; ``t`` itself on a
    one-rank mesh."""
    if mesh.size() == 1:
        return t
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def sum_over_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over ``mesh``'s batch axes (a new tensor)."""
    for a in batch_axes(mesh) or ():
        t = all_reduce_sum(t, a, mesh)
    return t


def same_on_every_rank(tensors: Sequence[torch.Tensor], mesh) -> bool:
    """True iff every rank of the mesh holds ``tensors`` bitwise equal to
    rank 0's: each one's bytes broadcast from rank 0 and compared in turn,
    on the mesh's device."""
    if mesh.size() == 1:
        return True
    dev = _device_type(mesh)
    same = True
    for t in tensors:
        b = t.detach().reshape(-1).contiguous().to(dev)
        b = b.to(torch.uint8) if b.dtype == torch.bool \
            else b.view(torch.uint8)
        ref = b.clone()
        dist.broadcast(ref, src=0)
        same = same and bool(torch.equal(ref, b))
    flag = torch.tensor([0 if same else 1], dtype=torch.int64, device=dev)
    dist.all_reduce(flag)
    return int(flag) == 0


def barrier(mesh) -> None:
    if mesh.size() > 1:
        dist.barrier()


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


# ------------------------------------------- exchanges with a backward


class _AllToAll(torch.autograd.Function):
    """Block ``i`` of dim 0 goes to rank ``i``; the block from rank ``s``
    lands at index ``s``. With equal blocks the exchange is its own
    transpose, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(t: torch.Tensor, name: str, mesh=None) -> torch.Tensor:
    """``t`` [n, ...] over ``name``'s n ranks -> [n, ...] whose block ``s``
    is rank s's block at this rank's index (``lax.all_to_all`` with
    ``split_axis = concat_axis = 0``). Differentiable."""
    n = axis_size(name, mesh)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all over {name!r}: {n} ranks but dim 0 "
                         f"of {tuple(t.shape)}")
    if n == 1:
        return t
    return _AllToAll.apply(t, _group(name, mesh))


def all_to_all_local(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`all_to_all` in one process: ``parts[r]`` is rank r's [n, ...]
    send buffer; returns each rank's receive buffer, ``out[r][s] =
    parts[s][r]``."""
    n = len(parts)
    return [torch.stack([parts[s][r] for s in range(n)]) for r in range(n)]


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's block along ``dim``; the backward sums
    every rank's gradient and hands each owner its block (gloo has no
    reduce-scatter, so an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, t, name, mesh, dim):
        ctx.name, ctx.mesh, ctx.dim = name, mesh, dim
        ctx.n, ctx.index = axis_size(name, mesh), axis_index(name, mesh)
        return all_gather_cat(t, name, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous(), ctx.name, ctx.mesh)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index], None, None, None


def all_gather(t: torch.Tensor, name: str, mesh=None,
               dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_cat` with a backward (every rank's blocks the same
    size)."""
    if axis_size(name, mesh) == 1:
        return t
    return _AllGather.apply(t, name, mesh, dim)


def all_gather_local(parts: Sequence[torch.Tensor],
                     dim: int = 0) -> List[torch.Tensor]:
    """:func:`all_gather` in one process: every rank's result."""
    whole = torch.cat(list(parts), dim=dim)
    return [whole] * len(parts)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (:func:`batch_rows`) -> the global batch along dim
    0, gathered over ``mesh``'s batch axes, innermost first. Differentiable."""
    for a in reversed(batch_axes(mesh) or ()):
        t = all_gather(t, a, mesh, dim=0)
    return t
