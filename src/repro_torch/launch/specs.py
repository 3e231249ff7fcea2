"""Sharding specs of the training state (port of the shardings half of
``repro/launch/specs.py``: ``param_shardings_sane`` and
``state_shardings``), and the cut and the gather that move a state between
its global leaves and one rank's blocks.

A layout is a :class:`repro_torch.distributed.sharding.Layout` a leaf: the
reference's rule spec, sanitized against the leaf's shape, and this rank's
block. One rule is the port's own: a ``>= 2``-D float leaf keeps an axis on
its alignment dim (``ndim - 2``, :func:`repro_torch.core.align.
_leaf_group_axis`) only if each block holds whole exponent groups of
``n_group`` rows, so the frozen-exponent projection and the alignment of a
block never need a neighbour's rows. The frozen exponents, signs, moments
and error-feedback residuals take their parameter's spec.

The rest of the reference's file (input specs, cache shardings, the dry
run's) waits for ROADMAP Queue 1 item 16.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from repro_torch.distributed import sharding as shlib

NGroup = Union[int, Callable[[str], int]]


def _n_group_of(n_group: NGroup, path: str) -> int:
    return int(n_group(path) if callable(n_group) else n_group)


def group_rule(spec: tuple, shape, mesh, n_group: int) -> tuple:
    """``spec`` without the axis on dim ``ndim - 2`` when its blocks would
    cut an exponent group of ``n_group`` rows (``>= 2``-D leaves only)."""
    if len(shape) < 2 or spec[len(shape) - 2] is None:
        return spec
    g = len(shape) - 2
    parts = 1
    for a in shlib._spec_axes(spec[g]):
        parts *= shlib.axis_size(a, mesh)
    if (shape[g] // parts) % n_group == 0:
        return spec
    return spec[:g] + (None,) + spec[g + 1:]


def leaf_spec(mesh, path: str, t, n_group: NGroup = 8,
              serve_replicated: bool = False) -> tuple:
    """The final spec of one leaf: rule (``"data"`` dropped for the
    inference layout), sanitize, then the group rule."""
    spec = shlib.param_spec(path, t.ndim, mesh)
    if serve_replicated:
        spec = tuple(None if ax == "data" else ax for ax in spec)
    spec = shlib.sanitize_spec(mesh, spec, t.shape)
    if t.ndim >= 2 and t.is_floating_point():
        spec = group_rule(spec, tuple(t.shape), mesh,
                          _n_group_of(n_group, path))
    return spec


def param_shardings_sane(mesh, tree: Mapping, n_group: NGroup = 8,
                         serve_replicated: bool = False
                         ) -> Dict[str, shlib.Layout]:
    """``{path: Layout}`` of a parameter tree: the training layout, or with
    ``serve_replicated`` the reference's inference layout, every leaf
    replicated over ``"data"`` (an entry that is ``"data"`` alone dropped
    from its spec, as the reference drops it) and split over ``"model"``
    only."""
    return {p: shlib.layout_of(leaf_spec(mesh, p, t, n_group,
                                         serve_replicated), t.shape, mesh)
            for p, t in tree.items()}


def _like(layouts: Mapping, tree: Mapping, mesh) -> dict:
    """Layouts of a tree whose leaves take their parameter's spec (None
    stays None)."""
    out = {}
    for p, t in tree.items():
        if t is None:
            out[p] = None
            continue
        spec = shlib.sanitize_spec(mesh, layouts[p].spec, t.shape)
        out[p] = shlib.layout_of(spec, t.shape, mesh)
    return out


def state_shardings(mesh, state, n_group: NGroup = 8):
    """The layouts of a :class:`~repro_torch.training.steps.TrainState` of
    global leaves, as a TrainState of ``{path: Layout}`` trees: params,
    ``m``, ``v``, frozen signs and residuals by the parameter rules; the
    frozen exponents by their parameter's spec over their own shape;
    ``step`` replicated."""
    from repro_torch.training.steps import TrainState
    params = param_shardings_sane(mesh, state.params, n_group=n_group)
    step = state.opt["step"]
    opt = {"m": _like(params, state.opt["m"], mesh),
           "v": _like(params, state.opt["v"], mesh),
           "step": shlib.layout_of((None,) * step.ndim, step.shape, mesh)}
    return TrainState(
        params=params, opt=opt, exps=_like(params, state.exps, mesh),
        signs=_like(params, state.signs, mesh),
        ef_error=None if state.ef_error is None
        else _like(params, state.ef_error, mesh))


def abstract_state(state, layouts: Mapping[str, shlib.Layout]):
    """A state of meta tensors of the global shapes of a state of blocks
    cut by ``layouts`` (``{path: Layout}`` of its parameters): a frozen
    exponent block ``[..., k/n, j]`` of a ``[..., k, j]`` block stands for
    ``[..., ceil(K/n), J]``."""
    def meta(shape, dtype):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    def like(tree):
        return {p: None if t is None else meta(layouts[p].shape, t.dtype)
                for p, t in tree.items()}
    exps = {}
    for p, e in state.exps.items():
        if e is None:
            exps[p] = None
            continue
        lay, g = layouts[p], e.ndim - 2
        n = -(-lay.block[g] // e.shape[g])          # the group's rows
        shape = list(lay.shape)
        shape[g] = -(-lay.shape[g] // n)
        exps[p] = meta(shape, e.dtype)
    trees = {("params",): like(state.params), ("opt", "m"): like(
        state.opt["m"]), ("opt", "v"): like(state.opt["v"]),
        ("exps",): exps, ("signs",): like(state.signs)}
    if state.ef_error is not None:
        trees[("ef_error",)] = like(state.ef_error)
    return _rebuild(state, trees, None)


def _trees(state):
    """(field path, {leaf path: tensor}) of every tree of a state."""
    yield ("params",), state.params
    yield ("opt", "m"), state.opt["m"]
    yield ("opt", "v"), state.opt["v"]
    yield ("exps",), state.exps
    yield ("signs",), state.signs
    if state.ef_error is not None:
        yield ("ef_error",), state.ef_error


def _field(state, where):
    node = getattr(state, where[0])
    return node[where[1]] if len(where) > 1 else node


def _rebuild(state, trees: dict, shards):
    from repro_torch.training.steps import TrainState
    opt = {"m": trees[("opt", "m")], "v": trees[("opt", "v")],
           "step": state.opt["step"]}
    return TrainState(params=trees[("params",)], opt=opt,
                      exps=trees[("exps",)], signs=trees[("signs",)],
                      ef_error=trees.get(("ef_error",)), shards=shards)


def shard_state(state, mesh, n_group: NGroup = 8, device=None):
    """A state of global leaves -> this rank's blocks (copies that own their
    storage, on ``device`` or each leaf's own), with ``shards`` the
    layouts. ``step`` stays replicated."""
    layouts = state_shardings(mesh, state, n_group)
    trees = {}
    for where, tree in _trees(state):
        lay = _field(layouts, where)
        trees[where] = {p: None if t is None else
                        lay[p].cut(t).to(device or t.device, copy=True)
                        .contiguous() for p, t in tree.items()}
    return _rebuild(state, trees, layouts)


def gather_leaf(t: torch.Tensor, layout: shlib.Layout, mesh,
                axes=None) -> torch.Tensor:
    """A block -> the region of its leaf that ``axes`` (default every axis
    the leaf is split on) span: all-gathered dim by dim, the innermost axis
    of a dim first."""
    axes = layout.axes if axes is None else axes
    for i, ax in enumerate(layout.spec):
        for a in reversed(shlib._spec_axes(ax)):
            if a in axes:
                t = shlib.all_gather_cat(t, a, mesh, dim=i)
    return t


def gather_tree(tree: Mapping, layouts: Mapping, mesh,
                dst: Optional[int] = None):
    """A ``{path: block}`` tree laid out by ``layouts`` -> the tree of
    global leaves, gathered one leaf at a time. With ``dst`` only that rank
    keeps them, as host copies (the others get None)."""
    import torch.distributed as dist
    keep = dst is None or dist.get_rank() == dst
    out = {}
    for p, t in tree.items():
        whole = None if t is None else gather_leaf(t, layouts[p], mesh)
        if dst is not None and whole is not None:
            whole = whole.to("cpu", copy=True) if keep else None
        out[p] = whole
        del whole
    return out if keep else None


def gather_state(state, mesh, dst: Optional[int] = None):
    """A sharded state -> the state of global leaves (:func:`gather_tree`
    a tree; with ``dst`` only that rank gets it): what a checkpoint
    writes."""
    trees = {where: gather_tree(tree, _field(state.shards, where), mesh, dst)
             for where, tree in _trees(state)}
    if trees[("params",)] is None:
        return None
    return _rebuild(state, trees, None)


def gather_local(states, layouts_of_rank) -> "object":
    """Every emulated rank's blocks (``states[r]``, laid out by
    ``layouts_of_rank[r]``, a :func:`state_shardings` result) -> the state
    of global leaves: the in-process form of :func:`gather_state`."""
    trees = {}
    first = states[0]
    for where, tree in _trees(first):
        out = {}
        for p, t in tree.items():
            if t is None:
                out[p] = None
                continue
            blocks = [_field(s, where)[p] for s in states]
            lays = [_field(lr, where)[p] for lr in layouts_of_rank]
            out[p] = assemble(blocks, lays)
        trees[where] = out
    return _rebuild(first, trees, None)


def assemble(blocks, layouts) -> torch.Tensor:
    """Blocks of one leaf, one a rank (replicas included), -> the leaf."""
    lay0 = layouts[0]
    out = torch.empty(lay0.shape, dtype=blocks[0].dtype,
                      device=blocks[0].device)
    for b, lay in zip(blocks, layouts):
        lay.cut(out).copy_(b)
    return out
