"""Expert-parallel MoE dispatch by all-to-all over the mesh's ``"model"``
axis (port of ``repro/models/moe_a2a.py``).

Rank (d, m) of a ``("data", "model")`` mesh holds data rank d's rows of
the batch and the m-th slice of the sequence: a distinct token slice. It

  1. routes its local tokens (top-k over the replicated router),
  2. packs them into per-(owner, local expert) capacity slots: capacity
     ``max(8, ceil(T_loc k cf / E))`` over the LOCAL tokens, slot
     ``id * C + rank``, reshaped ``[ep, E_loc * C, D]`` by owner
     ``e // E_loc``,
  3. exchanges the slots over ``"model"`` (:func:`repro_torch.distributed.
     sharding.all_to_all`), so owner m holds ``[E_loc, ep * C, D]``
     (senders merged),
  4. runs its experts ``[m E_loc, (m + 1) E_loc)`` of the replicated
     leaves,
  5. sends the results back by the reverse layout and combines them with
     the gates,

then all-gathers its output over ``"model"`` along the sequence. The aux
loss is each rank's local Switch aux, averaged over every mesh rank. So
rank r's output, and which assignments it drops, are the dense dispatch's
(:class:`repro_torch.models.moe.MoE`) on rank r's token slice alone at the
same capacity formula, whether or not capacity binds.

:func:`apply_moe_a2a_local` runs the same stages for every rank in one
process (the exchanges' in-process forms): how one CPU process or one card
emulates the mesh, and the one-device oracle that a mesh's result is held
to.

Routing (:func:`route`, the reference's ``apply_moe``): the all-to-all runs
only with ``moe_dispatch="a2a"`` under an ambient mesh (``sharding.
set_mesh`` / ``use_mesh``) with a ``"model"`` axis dividing ``n_experts``,
batch axes dividing the global batch and ``"model"`` dividing the
sequence; anything else (decode's S = 1 included) takes the dense
dispatch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.models.moe import combine, pack, route_tokens, run_experts


def route(cfg, b: int, s: int) -> bool:
    """True iff a ``[b, s, D]`` MoE input takes the all-to-all under the
    ambient mesh: the reference's conditions; False for the dense
    dispatch. ``b`` is the rows this rank holds (under
    :func:`sharding.split_rows`, its block of the global batch)."""
    mesh = shlib.get_mesh()
    if cfg.moe_dispatch != "a2a" or mesh is None \
            or shlib.MODEL_AXIS not in shlib.axis_names(mesh):
        return False
    rows = shlib.rows_mesh()
    global_b = b * shlib.batch_ranks(rows) if rows is not None else b
    ep = shlib.axis_size(shlib.MODEL_AXIS, mesh)
    return not (cfg.n_experts % ep or global_b % shlib.batch_ranks(mesh)
                or s % ep)


def _expert_slice(w, index: int, ep: int):
    e_loc = w.shape[0] // ep
    return w[index * e_loc:(index + 1) * e_loc]


def moe_a2a_rank(weights, x_loc, cfg, mesh=None):
    """One rank's body (the reference's ``_moe_a2a_local``): ``weights``
    ``(router, moe_wgate, moe_win, moe_wout)`` replicated, ``x_loc`` [T_loc,
    D] this rank's tokens -> (out [T_loc, D], its local aux, its keep
    mask [T_loc * k])."""
    router, w_gate, w_in, w_out = weights
    ep = shlib.axis_size(shlib.MODEL_AXIS, mesh)
    m = shlib.axis_index(shlib.MODEL_AXIS, mesh)
    gates, ids, aux = route_tokens(router, x_loc, cfg)
    send, keep, dest, c = pack(x_loc, ids, cfg, ep)
    recv = shlib.all_to_all(send, shlib.MODEL_AXIS, mesh)
    back = run_experts(recv, *(_expert_slice(w, m, ep)
                               for w in (w_gate, w_in, w_out)), c)
    ret = shlib.all_to_all(back, shlib.MODEL_AXIS, mesh)
    return combine(ret, keep, dest, gates, c, cfg), aux, keep


def moe_a2a_ranks(weights, xs: Sequence[torch.Tensor], cfg):
    """Every rank of one ``"model"`` group in this process: ``xs[r]`` is
    rank r's tokens [T_loc, D] -> (outs, auxes, keeps), one a rank, through
    the exchanges' in-process forms."""
    router, w_gate, w_in, w_out = weights
    ep = len(xs)
    routed = [route_tokens(router, x, cfg) for x in xs]
    packed = [pack(x, ids, cfg, ep) for x, (_, ids, _) in zip(xs, routed)]
    recvs = shlib.all_to_all_local([p[0] for p in packed])
    backs = [run_experts(recv, *(_expert_slice(w, r, ep)
                                 for w in (w_gate, w_in, w_out)),
                         packed[r][3])
             for r, recv in enumerate(recvs)]
    rets = shlib.all_to_all_local(backs)
    outs = [combine(ret, keep, dest, gates, c, cfg)
            for ret, (gates, _, _), (_, keep, dest, c)
            in zip(rets, routed, packed)]
    return outs, [a for _, _, a in routed], [p[1] for p in packed]


def _slices(b: int, s: int, data: int, model: int):
    """(rows, columns) of rank (d, m)'s token block, in rank order."""
    pb, ps = b // data, s // model
    return [[(slice(d * pb, (d + 1) * pb), slice(m * ps, (m + 1) * ps))
             for m in range(model)] for d in range(data)]


def apply_moe_a2a_local(weights, cfg, x, data: int, model: int):
    """The mesh's all-to-all dispatch of ``x`` [B, S, D] (the global batch)
    with every one of the ``data x model`` ranks run in this process ->
    (out [B, S, D], the aux averaged over the ranks, the keep masks
    ``[data][model]`` of each rank's T_loc * k assignments)."""
    b, s, d = x.shape
    blocks = _slices(b, s, data, model)
    rows, auxes, keeps = [], [], []
    for group in blocks:
        xs = [x[r, c].reshape(-1, d) for r, c in group]
        outs, aux, keep = moe_a2a_ranks(weights, xs, cfg)
        rows.append(shlib.all_gather_local(
            [o.reshape(b // data, s // model, d) for o in outs], dim=1)[0])
        auxes += aux
        keeps.append(keep)
    return torch.cat(rows, dim=0), torch.stack(auxes).mean(), keeps


def apply_moe_a2a(weights, cfg, x, mesh=None):
    """The all-to-all dispatch of ``x`` on this rank of the ambient (or
    given) mesh -> (out, aux), ``x`` and ``out`` as the layer holds them:
    this rank's rows under :func:`sharding.split_rows`, else the global
    batch (then this rank runs its block and gathers the rest).

    The aux's value is the mean of every mesh rank's local aux, as the
    reference's ``pmean``; its gradient is this rank's local aux's alone,
    so a training step that weights it 1/ranks and sums the gradients over
    the ranks differentiates that mean once."""
    mesh = mesh if mesh is not None else shlib.get_mesh()
    b, s, d = x.shape
    ep = shlib.axis_size(shlib.MODEL_AXIS, mesh)
    m = shlib.axis_index(shlib.MODEL_AXIS, mesh)
    whole = shlib.rows_mesh() is None
    rows = shlib.batch_rows(b, mesh) if whole else slice(None)
    x_blk = x[rows, m * (s // ep):(m + 1) * (s // ep)]
    out, aux, _ = moe_a2a_rank(weights, x_blk.reshape(-1, d), cfg, mesh)
    out = shlib.all_gather(out.reshape(x_blk.shape), shlib.MODEL_AXIS, mesh,
                           dim=1)
    if whole:
        out = shlib.gather_rows(out, mesh)
    mean = shlib.all_reduce_mesh(aux.detach().clone(), mesh) / mesh.size()
    return out, aux + (mean - aux).detach()

