"""The ambient device mesh, its combines and the parameter sharding rules
(port of ``repro/distributed/sharding.py``).

A module-level "current mesh" (a ``torch.distributed`` ``DeviceMesh`` with
named dims, :mod:`repro_torch.launch.mesh`) keeps model code mesh-agnostic:
with no mesh set every query answers as for one device. A second ambient
setting, :func:`split_rows`, says that activations hold only this rank's
rows of the batch (data parallelism: the training step and the mesh serve
keep their data rank's rows when the batch axes divide the batch), so a
layer that needs the global batch (the MoE's dense dispatch) gathers it.

The reference maps logical tensor axes onto its mesh for GSPMD. The port
keeps its parameter rules (:func:`logical`, :func:`sanitize_spec`,
:func:`param_spec`, :func:`param_specs`) and turns a spec into a per-leaf
:class:`Layout`: this rank's block of the global leaf, its shape and its
global offsets (:func:`layout_of`, :func:`param_shardings`). A spec is a
tuple with one entry per dim: ``None``, a mesh-axis name, or a tuple of
names (the block index over several axes is row-major, the first axis
outermost, as GSPMD's). The ZeRO-3 training step
(:mod:`repro_torch.training.zero3`) holds its state in such blocks and
gathers a layer's leaves before the layer computes. The reference's
activation constraint ``shard`` changes no values and is not ported.

The combines below run on one mesh dim's process group: NCCL on the card,
gloo on the CPU. gloo wants contiguous tensors of dtypes it knows, so words
travel as int64 masked to 32 bits and values as float32. The exchanges
that a differentiated forward crosses (:func:`all_to_all`,
:func:`all_gather`) carry their backward: the reverse exchange, and the sum
of every rank's gradient back to the owner of each block. Each has an
in-process form (:func:`all_to_all_local`, :func:`all_gather_local`,
:func:`reduce_scatter_local`) over a list of per-rank tensors, with which
one process emulates the ranks; :class:`VirtualMesh` stands for one rank
of an emulated mesh wherever a layout is computed, and a
:class:`ThreadMesh` for one rank of a mesh whose ranks run in threads of
this process, whose combines are in-process exchanges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_CURRENT_MESH = None
_ROWS_MESH = None          # the mesh whose batch axes split the activations
MODEL_AXIS = "model"       # the dim that splits and combines the SRAM image
# the ambient settings of a thread that runs one rank of an emulated mesh
# (rank_thread); every other thread shares the module's
_LOCAL = threading.local()


def _ambient() -> Optional[dict]:
    return getattr(_LOCAL, "ambient", None)


def set_mesh(mesh) -> None:
    global _CURRENT_MESH
    own = _ambient()
    if own is not None:
        own["mesh"] = mesh
    else:
        _CURRENT_MESH = mesh


def get_mesh():
    own = _ambient()
    return own["mesh"] if own is not None else _CURRENT_MESH


@contextlib.contextmanager
def rank_thread():
    """Within the block this thread keeps its own ambient mesh and
    split-rows setting (starting from the shared ones), so threads that run
    the ranks of an emulated mesh (:func:`thread_ranks`) each set their own
    (:func:`use_mesh`, :func:`split_rows`)."""
    prev = _ambient()
    _LOCAL.ambient = {"mesh": get_mesh(), "rows": rows_mesh()}
    try:
        yield
    finally:
        _LOCAL.ambient = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the block; the previous one comes
    back on any exit."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def _set_rows(mesh) -> None:
    global _ROWS_MESH
    own = _ambient()
    if own is not None:
        own["rows"] = mesh
    else:
        _ROWS_MESH = mesh


@contextlib.contextmanager
def split_rows(mesh):
    """Within the block, activations hold this rank's rows of the batch,
    split over ``mesh``'s batch axes (:func:`batch_rows`); ``None`` means
    every rank holds the whole batch. The previous setting comes back on
    any exit."""
    prev = rows_mesh()
    _set_rows(mesh)
    try:
        yield mesh
    finally:
        _set_rows(prev)


def rows_mesh():
    """The mesh of the enclosing :func:`split_rows`, or None."""
    own = _ambient()
    return own["rows"] if own is not None else _ROWS_MESH


def axis_names(mesh=None) -> Tuple[str, ...]:
    mesh = mesh if mesh is not None else get_mesh()
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(name: str, mesh=None) -> int:
    """Ranks along ``name`` (1 without a mesh or without that dim)."""
    mesh = mesh if mesh is not None else get_mesh()
    names = axis_names(mesh)
    if name not in names:
        return 1
    return int(mesh.size(mesh_dim=names.index(name)))


def axis_index(name: str, mesh=None) -> int:
    """This rank's coordinate along ``name`` (0 without it)."""
    mesh = mesh if mesh is not None else get_mesh()
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
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.get_group(mesh_dim=name)


def _mesh(mesh):
    return mesh if mesh is not None else get_mesh()


def _threaded(mesh) -> bool:
    """True for a rank of a mesh emulated in this process
    (:class:`ThreadMesh`): the combines run in process."""
    return isinstance(_mesh(mesh), ThreadMesh)


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of ``parts`` in rank order (a new tensor)."""
    whole = parts[0].clone()
    for p in parts[1:]:
        whole = whole + p
    return whole


def all_gather_cat(t: torch.Tensor, name: str, mesh=None,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``name``, concatenated in rank order along
    ``dim`` (``t`` itself when the dim has one rank)."""
    n = axis_size(name, mesh)
    if n == 1:
        return t
    if _threaded(mesh):
        return _mesh(mesh).exchange(t, lambda ps: torch.cat(
            _mesh(mesh).line(ps, name), dim=dim))
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=_group(name, mesh))
    return torch.cat(parts, dim=dim)


def all_reduce_sum(t: torch.Tensor, name: str, mesh=None) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``name`` (a new tensor)."""
    if axis_size(name, mesh) == 1:
        return t
    if _threaded(mesh):
        return _mesh(mesh).exchange(t, lambda ps: _sum(
            _mesh(mesh).line(ps, name)))
    t = t.clone().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(name, mesh))
    return t


def all_reduce_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``t`` over the whole mesh (its size is the
    world's, :mod:`repro_torch.launch.mesh`), in place; ``t`` itself on a
    one-rank mesh."""
    if mesh.size() == 1:
        return t
    if _threaded(mesh):
        return t.copy_(mesh.exchange(t, _sum))
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


def first_value(x: float, mesh=None) -> float:
    """Rank 0's ``x`` on every rank of ``mesh`` (the ambient one by
    default; ``x`` itself without a mesh or on one rank): what a rank reads
    from its own clock, decided once for all of them."""
    mesh = _mesh(mesh)
    names = axis_names(mesh)
    if all(axis_size(a, mesh) == 1 for a in names):
        return x
    dev = "cuda" if _device_type(mesh) == "cuda" else "cpu"
    t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
    for a in names:
        t = all_gather_cat(t, a, mesh)[:1]
    return float(t.item())


def all_gather_world(obj, mesh) -> list:
    """Every rank's picklable ``obj`` over the whole of ``mesh``, which
    spans the world (or every thread of an emulated one), in rank order."""
    if mesh.size() == 1:
        return [obj]
    if _threaded(mesh):
        return mesh.exchange(obj, list)
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}")
    out = [None] * mesh.size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_objects(obj, name: str, mesh=None) -> list:
    """Every rank's picklable ``obj`` along ``name``, in rank order."""
    n = axis_size(name, mesh)
    if n == 1:
        return [obj]
    if _threaded(mesh):
        return _mesh(mesh).exchange(obj, lambda ps: _mesh(mesh).line(ps, name))
    out = [None] * n
    dist.all_gather_object(out, obj, group=_group(name, mesh))
    return out


def _device_type(mesh=None) -> str:
    mesh = mesh if mesh is not None else get_mesh()
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
        # the mesh resolved now: the backward may run on another thread
        ctx.name, ctx.mesh, ctx.dim = name, _mesh(mesh), dim
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


def reduce_scatter(t: torch.Tensor, name: str, mesh=None,
                   dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``name``, cut into the dim's n
    equal blocks along ``dim``: this rank's block (``t`` itself when the
    dim has one rank). NCCL reduce-scatters; gloo has no reduce-scatter,
    so an all-reduce and a slice."""
    n = axis_size(name, mesh)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {name!r}: {n} ranks do not "
                         f"divide dim {dim} of {tuple(t.shape)}")
    if _threaded(mesh):
        return _mesh(mesh).exchange(t, lambda ps: reduce_scatter_local(
            _mesh(mesh).line(ps, name), dim)[axis_index(name, mesh)])
    if _device_type(mesh) != "cuda":
        whole = all_reduce_sum(t.contiguous(), name, mesh)
        return whole.chunk(n, dim=dim)[axis_index(name, mesh)].contiguous()
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=_group(name, mesh))
    return out.movedim(0, dim).contiguous()


def reduce_scatter_local(parts: Sequence[torch.Tensor],
                         dim: int = 0) -> List[torch.Tensor]:
    """:func:`reduce_scatter` in one process: ``parts[r]`` is rank r's
    tensor; returns each rank's block of their sum (summed in rank
    order)."""
    whole = parts[0]
    for p in parts[1:]:
        whole = whole + p
    return [b.contiguous() for b in whole.chunk(len(parts), dim=dim)]


def all_reduce_max_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of every rank's ``t`` over the whole mesh (a new
    tensor; ``t`` itself on a one-rank mesh)."""
    if mesh.size() == 1:
        return t
    if _threaded(mesh):
        return mesh.exchange(t, lambda ps: functools.reduce(torch.maximum,
                                                            ps))
    t = t.clone().contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


# ------------------------------------------------- stand-in meshes


class VirtualMesh:
    """One rank of a mesh that is not there: ``names`` and ``sizes`` of its
    dims and this rank's ``coords``. It answers the queries a layout needs
    (:func:`axis_size`, :func:`axis_index`), so one process computes every
    rank's block (``ranks_of``); it runs no collective."""

    device_type = "cpu"

    def __init__(self, names: Sequence[str], sizes: Sequence[int],
                 coords: Sequence[int] = ()):
        self.mesh_dim_names = tuple(names)
        self._sizes = tuple(int(v) for v in sizes)
        self._coords = tuple(coords) or (0,) * len(self._sizes)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        if mesh_dim is not None:
            return self._sizes[mesh_dim]
        n = 1
        for v in self._sizes:
            n *= v
        return n

    def get_local_rank(self, mesh_dim) -> int:
        if isinstance(mesh_dim, str):
            mesh_dim = self.mesh_dim_names.index(mesh_dim)
        return self._coords[mesh_dim]

    def __repr__(self):
        return (f"VirtualMesh({dict(zip(self.mesh_dim_names, self._sizes))}"
                f", coords={self._coords})")


def ranks_of(names: Sequence[str], sizes: Sequence[int]) -> List[VirtualMesh]:
    """Every rank of a ``names`` x ``sizes`` mesh, in rank order (row-major
    over the dims, as ``init_device_mesh`` numbers them)."""
    out = [()]
    for n in sizes:
        out = [c + (i,) for c in out for i in range(int(n))]
    return [VirtualMesh(names, sizes, c) for c in out]


def _row_major(sizes, coords) -> int:
    i = 0
    for n, c in zip(sizes, coords):
        i = i * n + c
    return i


class LocalGroup:
    """The ranks of a mesh emulated in this process, one thread each
    (:func:`thread_ranks`). :meth:`exchange` is their one collective;
    ``trees`` holds each rank's parameters for the ZeRO-3 gather that reads
    them (:class:`repro_torch.training.zero3.LocalGather`)."""

    def __init__(self, n: int, timeout: float):
        self.meshes: List["ThreadMesh"] = []
        self.trees: list = [None] * n
        self._slots: list = [None] * n
        self._barrier = threading.Barrier(n, timeout=timeout)

    def exchange(self, rank: int, t: torch.Tensor, fn):
        """Rank ``rank``'s part of a collective: every rank deposits its
        ``t``, then each computes ``fn`` of the ranks' tensors in rank order
        before any rank goes on (so a rank may then write ``t`` in place).
        Device work is ordered by the one stream the threads share."""
        self._slots[rank] = t
        self._barrier.wait()
        try:
            return fn(list(self._slots))
        finally:
            self._barrier.wait()

    def abort(self) -> None:
        """A rank failed: every rank waiting in an exchange raises."""
        self._barrier.abort()

    def reset(self) -> None:
        self._barrier.reset()
        self._slots = [None] * len(self._slots)


class ThreadMesh(VirtualMesh):
    """One rank of a mesh emulated in this process, whose combines
    (:func:`all_gather_cat`, :func:`all_reduce_sum`, :func:`all_reduce_mesh`,
    :func:`reduce_scatter`, :func:`all_reduce_max_mesh`) exchange tensors
    with the other ranks' threads through their :class:`LocalGroup`, summing
    in rank order."""

    def __init__(self, names, sizes, coords, group: LocalGroup):
        super().__init__(names, sizes, coords)
        self.group = group
        self.rank = _row_major(self._sizes, self._coords)

    def exchange(self, t: torch.Tensor, fn):
        return self.group.exchange(self.rank, t, fn)

    def at(self, name: str, k: int) -> "ThreadMesh":
        """The rank whose coordinate along ``name`` is ``k``, the others
        this rank's."""
        c = list(self._coords)
        c[self.mesh_dim_names.index(name)] = k
        return self.group.meshes[_row_major(self._sizes, c)]

    def line(self, parts: Sequence, name: str) -> list:
        """The entries of ``parts`` (one a rank, in rank order) of the ranks
        along ``name`` through this rank."""
        return [parts[self.at(name, k).rank]
                for k in range(axis_size(name, self))]


def thread_ranks(names: Sequence[str], sizes: Sequence[int],
                 timeout: float = 600.0) -> List[ThreadMesh]:
    """Every rank of a ``names`` x ``sizes`` mesh emulated in this process,
    in rank order, sharing one :class:`LocalGroup` (an exchange that waits
    ``timeout`` seconds for the other ranks raises)."""
    group = LocalGroup(len(ranks_of(names, sizes)), timeout)
    group.meshes = [ThreadMesh(names, sizes, m._coords, group)
                    for m in ranks_of(names, sizes)]
    return group.meshes


# ------------------------------------------ parameter sharding rules


def logical(*names, mesh=None) -> tuple:
    """A spec from logical axis names (None passes through): ``batch`` ->
    the batch axes, ``heads`` / ``kv_heads`` / ``kv_seq`` / ``ff`` /
    ``vocab`` / ``experts`` -> ``"model"``, ``fsdp`` -> ``"data"``, each
    where ``mesh`` (default the ambient one) has that axis; ``seq`` ->
    ``"model"`` (the reference's sequence parallelism, on by default)."""
    axes = axis_names(mesh)
    model = MODEL_AXIS if MODEL_AXIS in axes else None
    table = {"batch": batch_axes(mesh), "seq": model, "heads": model,
             "kv_heads": model, "kv_seq": model, "ff": model,
             "vocab": model, "experts": model,
             "fsdp": "data" if "data" in axes else None, None: None}
    return tuple(table[n] for n in names)


def _spec_axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def sanitize_spec(mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """Drop the spec's axes whose dim the mesh extent does not divide (the
    reference's rule: e.g. granite-3-8b's vocab of 49155 on a 2-way
    ``"model"`` axis stays whole)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        size = 1
        for a in _spec_axes(ax):
            size *= axis_size(a, mesh)
        out.append(ax if shape[i] % size == 0 else None)
    return tuple(out)


# Leaf path names follow the model zoo's conventions. ``tail`` is the spec of
# the trailing dims; leading dims (e.g. the stacked layer axis) get None.
_PARAM_RULES = [
    # embeddings (order matters: "embed$" would also match "unembed")
    (r"unembed$",          ("fsdp", "vocab")),
    (r"(^|/)embed$",       ("vocab", "fsdp")),
    # attention (merged-head 2-D layouts [D, H*hd] / [H*hd, D])
    (r"(wq|wk|wv|wkv)$",   ("fsdp", "heads")),
    (r"wo$",               ("heads", "fsdp")),
    # dense mlp
    (r"(w_gate|w_in|w_up)$", ("fsdp", "ff")),
    (r"w_out$",            ("ff", "fsdp")),
    # MoE: experts on "model" (EP); router replicated over model
    (r"moe_win$",          ("experts", "fsdp", None)),
    (r"moe_wgate$",        ("experts", "fsdp", None)),
    (r"moe_wout$",         ("experts", None, "fsdp")),
    (r"router$",           ("fsdp", None)),
    # rwkv6 / rg-lru projections
    (r"(w_r|w_k|w_v|w_g|w_x|w_gate_br)$", ("fsdp", "heads")),
    (r"(w_o|w_down)$",     ("heads", "fsdp")),
    # small lora/mix/decay/norm/bias params: replicated (negligible bytes)
]


def param_spec(path: str, ndim: int, mesh=None) -> tuple:
    """The spec of the leaf at ``path`` with ``ndim`` dims: the first rule
    that matches gives its trailing dims (a rule longer than the leaf
    leaves it replicated)."""
    for pattern, tail in _PARAM_RULES:
        if re.search(pattern, path):
            tail_spec = logical(*tail, mesh=mesh)
            if len(tail_spec) > ndim:   # e.g. 2-D rule on 1-D leaf
                break
            return (None,) * (ndim - len(tail_spec)) + tail_spec
    return (None,) * ndim


def param_specs(params: Mapping, mesh=None) -> Dict[str, tuple]:
    """``{path: spec}`` of a ``{path: tensor}`` tree."""
    return {p: param_spec(p, w.ndim, mesh) for p, w in params.items()}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One rank's block of a global leaf: the ``spec`` (sanitized), the
    global ``shape``, the block's ``block`` shape and its global
    ``offsets``."""

    spec: tuple
    shape: Tuple[int, ...]
    block: Tuple[int, ...]
    offsets: Tuple[int, ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is split on, in spec order."""
        return tuple(a for ax in self.spec for a in _spec_axes(ax))

    @property
    def whole(self) -> bool:
        return self.block == self.shape

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``t`` (a view)."""
        for i, (o, b) in enumerate(zip(self.offsets, self.block)):
            if b != t.shape[i]:
                t = t.narrow(i, o, b)
        return t


def layout_of(spec: Sequence, shape: Sequence[int], mesh) -> Layout:
    """The block of a ``shape`` leaf under ``spec`` (already sanitized) that
    this rank of ``mesh`` holds."""
    shape = tuple(int(v) for v in shape)
    block, offsets = [], []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        parts, index = 1, 0
        for a in _spec_axes(ax):
            parts *= axis_size(a, mesh)
            index = index * axis_size(a, mesh) + axis_index(a, mesh)
        block.append(n // parts)
        offsets.append(index * (n // parts))
    return Layout(tuple(spec), shape, tuple(block), tuple(offsets))


def param_shardings(mesh, params: Mapping) -> Dict[str, Layout]:
    """``{path: Layout}``: each leaf's sanitized spec and this rank's block
    of it."""
    out = {}
    for p, w in params.items():
        spec = sanitize_spec(mesh, param_spec(p, w.ndim, mesh), w.shape)
        out[p] = layout_of(spec, w.shape, mesh)
    return out
