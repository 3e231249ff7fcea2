"""ZeRO-3: the training state sharded over a ``("data", "model")`` mesh.

Each rank holds the blocks of every leaf that the specs give it
(:mod:`repro_torch.launch.specs`): the parameters, AdamW's moments, the
frozen exponents and signs and the error-feedback residuals. The step
(:func:`repro_torch.training.steps.make_train_step` on a state whose
``shards`` are set) runs the forward layer group by layer group
(:func:`repro_torch.models.lm.forward_blocks`):

* :class:`LeafGather` all-gathers a leaf's block over every axis it is
  split on just before its layer computes (a MoE layer that takes the
  all-to-all gathers its experts over ``"data"`` only: each rank runs its
  own experts). Its backward reduce-scatters the gradient onto the blocks'
  owners and sums it over the axes the leaf is replicated on
  (:func:`scatter_grad`), so each block's gradient is the sum over the
  whole mesh that the replicated data-parallel step all-reduces. Under
  ``RunConfig.remat`` a group's gathered leaves are freed after its
  forward and gathered again for its backward.
* everything after the gradient runs on the blocks, through the functions
  of the replicated step: the clip by the global norm of the blocks (each
  block's sum of squares, a replicated block counted once, summed over the
  mesh, :func:`global_norm`), the int8 compression with the max of
  ``|g + e|`` over the leaf (:func:`leaf_max`), AdamW (elementwise) and the
  frozen-exponent projection (a block holds whole exponent groups); the
  exponent regularizer's penalty sums block partials (:func:`leaf_total`).

The sharded step updates the state it is given in place (the reference's
dry run lowers its sharded train step with the state donated), so a rank
holds one state, its gradients and one leaf's temporaries.

:func:`init_blocks` builds each rank's blocks of a fresh model leaf by leaf
from the seeded generator, bitwise the blocks of the one-device init, so no
card holds more than one layer's leaves whole. :func:`emulate_step` runs
the step of every rank of a mesh in one process, one thread a rank, with
in-process collectives: how one card runs the sharded step.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch

from repro_torch.distributed import sharding as shlib


def _row_layout(lay: shlib.Layout) -> shlib.Layout:
    """The layout of one row (dim 0) of a stacked leaf's layout."""
    return shlib.Layout(lay.spec[1:], lay.shape[1:], lay.block[1:],
                        lay.offsets[1:])


_TIMER = None     # {"gather": [...], "reduce_scatter": [...]} of event pairs


@contextlib.contextmanager
def time_collectives():
    """Within the block, every gather of :class:`LeafGather` and every
    reduce-scatter of its backward on a CUDA tensor is bracketed by two
    CUDA events on the current stream (the time that stream waits for the
    collective); yields ``{"gather": [(start, end), ...],
    "reduce_scatter": [...]}``, read with :func:`collective_ms` after a
    synchronize. Off by default: the step records nothing."""
    global _TIMER
    prev, _TIMER = _TIMER, {"gather": [], "reduce_scatter": []}
    try:
        yield _TIMER
    finally:
        _TIMER = prev


def collective_ms(timer: dict) -> Dict[str, float]:
    """The summed milliseconds of each kind of a :func:`time_collectives`
    record."""
    return {k: sum(a.elapsed_time(b) for a, b in pairs)
            for k, pairs in timer.items()}


def _timed(kind: str, t: torch.Tensor, fn):
    if _TIMER is None or t.device.type != "cuda":
        return fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    _TIMER[kind].append((a, b))
    return out


def scatter_grad(g: torch.Tensor, lay: shlib.Layout, mesh, axes,
                 replicated) -> torch.Tensor:
    """The gradient of a leaf gathered over ``axes`` -> this rank's block of
    its sum over the mesh: reduce-scattered over ``axes`` (the outer axis
    of a dim first), then summed over ``replicated``."""
    for i, ax in enumerate(lay.spec):
        for a in shlib._spec_axes(ax):
            if a in axes:
                g = shlib.reduce_scatter(g, a, mesh, dim=i)
    for a in replicated:
        g = shlib.all_reduce_sum(g.contiguous(), a, mesh)
    return g


class _Gather(torch.autograd.Function):
    """Forward: the block gathered over ``axes``. Backward:
    :func:`scatter_grad`."""

    @staticmethod
    def forward(ctx, t, lay, mesh, axes, replicated):
        from repro_torch.launch.specs import gather_leaf
        ctx.lay, ctx.mesh, ctx.axes, ctx.replicated = lay, mesh, axes, \
            replicated
        return _timed("gather", t, lambda: gather_leaf(t, lay, mesh, axes))

    @staticmethod
    def backward(ctx, g):
        return _timed("reduce_scatter", g, lambda: scatter_grad(
            g, ctx.lay, ctx.mesh, ctx.axes, ctx.replicated)), None, None, \
            None, None


def leaf_gather(layouts: Mapping[str, shlib.Layout], mesh) -> "LeafGather":
    """The gather of a sharded step on ``mesh``: :class:`LocalGather` for
    ranks emulated in this process (a :class:`sharding.ThreadMesh`), else
    :class:`LeafGather`."""
    cls = LocalGather if isinstance(mesh, shlib.ThreadMesh) else LeafGather
    return cls(layouts, mesh)


class LeafGather:
    """The ``gather`` of :func:`repro_torch.models.lm.forward_blocks` for a
    sharded state: ``layouts`` ``{path: Layout}`` of the parameters on
    ``mesh``. ``bytes`` counts what the forward gathers (the gathered
    tensors' sizes), for the step's report."""

    def __init__(self, layouts: Mapping[str, shlib.Layout], mesh):
        self.layouts, self.mesh = layouts, mesh
        self.names = shlib.axis_names(mesh)
        self.bytes = 0

    def __call__(self, path: str, t: torch.Tensor, row: Optional[int] = None,
                 local_experts: bool = False) -> torch.Tensor:
        lay = self.layouts[path]
        if row is not None:                  # a row of a stacked leaf
            lay = _row_layout(lay)
        axes = tuple(a for a in lay.axes
                     if not (local_experts and a == shlib.MODEL_AXIS))
        replicated = tuple(a for a in self.names if a not in lay.axes
                           and shlib.axis_size(a, self.mesh) > 1)
        axes = tuple(a for a in axes if shlib.axis_size(a, self.mesh) > 1)
        if not axes and not replicated:
            return t
        out = self._gather(t, (path, row), lay, axes, replicated)
        if axes and torch.is_grad_enabled():
            self.bytes += out.numel() * out.element_size()
        return out

    def _gather(self, t, key, lay, axes, replicated):
        return _Gather.apply(t, lay, self.mesh, axes, replicated)

    def settle(self, grads: Dict) -> Dict:
        """The blocks' gradients after the backward: as they are (the
        backward has reduce-scattered them)."""
        return grads


class _Kept(torch.autograd.Function):
    """Forward: :meth:`LocalGather._region`. Backward: the gradient kept
    on the gather (summed where a leaf is read twice), none passed on."""

    @staticmethod
    def forward(ctx, t, gather, key, lay, axes):
        ctx.gather, ctx.key = gather, key
        return gather._region(key, lay, axes, t.dtype)

    @staticmethod
    def backward(ctx, g):
        kept = ctx.gather.kept
        kept[ctx.key] = g if ctx.key not in kept else kept[ctx.key] + g
        return None, None, None, None, None


class LocalGather(LeafGather):
    """:class:`LeafGather` for the ranks of a mesh emulated in this process,
    one thread each (:func:`emulate_step`): its forward reads every rank's
    block from the group's shared trees (``mesh.group.trees``, the ranks'
    parameters, each rank's cast as this rank's ``t``) and concatenates
    them as the all-gather does, so no rank waits inside a forward or its
    recomputation, which autograd runs for every rank on its one device
    thread. Its backward keeps the gathered gradient; :meth:`settle`
    reduce-scatters each through the mesh's in-process collectives
    (:func:`scatter_grad`, the backward of :class:`LeafGather`) and adds it
    to the block's gradient."""

    def __init__(self, layouts, mesh):
        super().__init__(layouts, mesh)
        self.kept, self.plans = {}, {}

    def _gather(self, t, key, lay, axes, replicated):
        self.plans[key] = (lay, axes, replicated)
        return _Kept.apply(t, self, key, lay, axes)

    def _region(self, key, lay, axes, dtype) -> torch.Tensor:
        path, row = key
        trees = self.mesh.group.trees
        stages = [(i, a) for i, ax in enumerate(lay.spec)
                  for a in reversed(shlib._spec_axes(ax)) if a in axes]

        def region(m, n):       # what rank m holds after n gather stages
            if n == 0:
                b = trees[m.rank][path]
                return (b if row is None else b[row]).to(dtype)
            i, a = stages[n - 1]
            return torch.cat([region(m.at(a, k), n - 1)
                              for k in range(shlib.axis_size(a, m))], dim=i)
        out = region(self.mesh, len(stages))
        return out if stages else out.clone()

    def settle(self, grads: Dict) -> Dict:
        def order(key):
            return key[0], -1 if key[1] is None else key[1]
        for key in sorted(self.kept, key=order):
            path, row = key
            lay, axes, replicated = self.plans[key]
            g = scatter_grad(self.kept.pop(key), lay, self.mesh, axes,
                             replicated)
            (grads[path] if row is None else grads[path][row]).add_(g)
        return grads


def _owner(lay: shlib.Layout, mesh) -> bool:
    """True on the one rank of each group of replicas of a block (index 0
    along every axis the leaf is not split on)."""
    return all(shlib.axis_index(a, mesh) == 0
               for a in shlib.axis_names(mesh) if a not in lay.axes)


def global_norm(grads: Mapping, layouts: Mapping, mesh) -> torch.Tensor:
    """The global norm of the gradient that ``grads``' blocks hold: each
    block's sum of squares (a replicated block counted once), summed over
    the mesh (:func:`repro_torch.optim.adamw.clip_by_global_norm`'s
    ``norm``)."""
    sq = [g.to(torch.float32).square().sum() if _owner(layouts[p], mesh)
          else torch.zeros((), dtype=torch.float32, device=g.device)
          for p, g in grads.items()]
    total = torch.stack(sq).sum()
    return shlib.all_reduce_mesh(total, mesh).sqrt()


def leaf_max(mesh):
    """-> ``max_fn(path, local_max)`` for the compression: the max over the
    whole mesh of each block's max, the leaf's max bitwise."""
    def max_fn(path, local):
        return shlib.all_reduce_max_mesh(local, mesh)
    return max_fn


def leaf_total(mesh):
    """-> ``total(layout, partial)`` for the exponent regularizer
    (:func:`repro_torch.models.losses.exponent_compression_penalty`): a
    block's partial summed over the axes its leaf is split on."""
    def total(lay, part):
        for a in lay.axes:
            part = shlib.all_reduce_sum(part, a, mesh)
        return part
    return total


def init_blocks(cfg, generator: Optional[torch.Generator], device, mesh,
                n_group=8):
    """This rank's blocks of a fresh model's ``{path: tensor}`` tree and
    their ``{path: Layout}``: the leaves drawn from ``generator`` in the
    order :class:`repro_torch.models.lm.LM` draws them (embed, unembed, then
    a layer at a time), each cut to its block as soon as it is drawn."""
    from repro_torch import convert
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.models.common import embed_init, init_norm
    shapes = convert.flat_from_lm(lm.shell(cfg))
    layouts = specs.param_shardings_sane(mesh, shapes, n_group=n_group)
    dt = cfg.pdtype()
    out = {}
    for name in ("embed", "unembed"):
        shape = (cfg.vocab_size, cfg.d_model) if name == "embed" \
            else (cfg.d_model, cfg.vocab_size)
        w = embed_init(shape, generator=generator, device=device, dtype=dt)
        out[name] = layouts[name].cut(w).clone()
        del w
    for layer, (prefix, row) in enumerate(convert.layer_slots(cfg)):
        kind = cfg.layer_kind(layer)
        blk = lm.Block(cfg, kind, generator=generator, device=device)
        for mod, names in convert.block_leaves(cfg, kind).items():
            for name in names:
                path = f"{prefix}/{mod}/{name}"
                w = getattr(getattr(blk, mod), name).detach()
                lay = layouts[path]
                if row is None:
                    out[path] = lay.cut(w).clone()
                    continue
                if path not in out:
                    out[path] = torch.empty(lay.block, dtype=w.dtype,
                                            device=w.device)
                out[path][row].copy_(_row_layout(lay).cut(w))
        del blk
    for name, w in init_norm(cfg.norm_type, cfg.d_model, device=device,
                             dtype=dt).items():
        out[f"final_norm/{name}"] = layouts[f"final_norm/{name}"].cut(
            w).clone()
    return {p: out[p] for p in shapes}, layouts


# ------------------------------------------------ one process, n ranks


def emulate_step(cfg, run, states, meshes, batch):
    """One step of :func:`repro_torch.training.steps.make_train_step` on
    every rank of a mesh emulated in this process: rank r's sharded state
    ``states[r]`` on ``meshes[r]`` (:func:`sharding.thread_ranks`), each
    rank's step in a thread of its own. The step is the program's; the
    collectives are the in-process ones of :class:`sharding.ThreadMesh`,
    and the gather reads every rank's blocks (:class:`LocalGather`). Dense
    kinds only: the MoE's exchanges would wait inside autograd's one device
    thread. The sharded step updates each state in place. -> (states,
    rank 0's metrics, those of the global batch)."""
    import threading
    from repro_torch.training.steps import make_train_step
    if cfg.n_experts:
        raise ValueError("emulate_step: dense kinds only")
    group = meshes[0].group
    group.trees = [s.params for s in states]
    fns = [make_train_step(cfg, run, m) for m in meshes]
    out = [None] * len(states)

    def go(r):
        try:
            out[r] = fns[r](states[r], batch)
        except Exception as e:          # re-raised below
            out[r] = e
            group.abort()
    # each rank's step sets and resets the ambient split-rows mesh in turn
    with shlib.split_rows(shlib.rows_mesh()):
        threads = [threading.Thread(target=go, args=(r,))
                   for r in range(len(states))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    group.reset()
    errors = [o for o in out if isinstance(o, BaseException)]
    if errors:
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return [o[0] for o in out], out[0][1]
