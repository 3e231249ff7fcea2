"""Mixture-of-Experts layer (port of ``repro/models/moe.py``).

The dense dispatch: assignments are ranked per expert (by a stable sort, or
by the one-hot ``cumsum`` baseline), scattered into an ``[E, C, D]`` buffer
of capacity C per expert, run through per-expert SwiGLU products and
gathered back. ``moe_dispatch="a2a"`` routes through the expert-parallel
all-to-all (:mod:`repro_torch.models.moe_a2a`) exactly where the reference
does: under an ambient mesh with a ``"model"`` axis that divides the
experts, batch axes that divide the global batch and ``"model"`` dividing
the sequence. Everywhere else (no mesh, decode's S = 1) it falls back to
the sort dispatch, as the reference does. Where activations hold only this
rank's rows (``sharding.split_rows``: data parallelism), the dense
dispatch gathers the global batch over the batch axes first, so capacity,
drop set and aux are the global batch's, as GSPMD computes them in the
reference; each rank keeps its own rows of the output.

Ordering follows the reference: ``jax.lax.top_k`` puts the lower index
first among equal gates and ``jnp.argsort`` is stable, so the top-k here is
a stable descending sort and the ranking a stable argsort (``torch.topk``
and a plain ``torch.argsort`` promise neither); which tokens a binding
capacity drops depends on both.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
from torch import nn

from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import Leaves, dense_init

# the stacked per-expert weights ([E, D, F] a block, [G, E, D, F] stacked
# over groups): more than 2-D, so a plain CIMDeployment never packs them and
# an ExpertDeployment slices them into per-expert matrices
EXPERT_LEAF_NAMES = ("moe_win", "moe_wgate", "moe_wout")
# the MoE's leaves in flatten order
MOE_LEAVES = tuple(sorted(EXPERT_LEAF_NAMES + ("router",)))


def capacity(cfg, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, c)


def drop_free(cfg, tokens: int) -> bool:
    """True when capacity-based dispatch provably drops no token for any
    batch of up to ``tokens`` tokens: an expert's worst-case load in a
    t-token batch is t (a token's ``top_k`` experts are distinct), so
    ``capacity(cfg, t) >= t`` for every t keeps each token's expert output a
    function of its own buffer row, and co-batched tokens cannot couple.
    The capacity floor of 8 makes every batch of up to 8 tokens drop-free."""
    return all(capacity(cfg, t) >= t for t in range(1, tokens + 1))


def dispatch(cfg) -> str:
    """The ranking the dense dispatch uses: ``"cumsum"``, or the sort
    dispatch (``"sort"``, and ``"a2a"`` where the all-to-all does not run,
    as the reference falls back)."""
    if cfg.moe_dispatch not in ("a2a", "sort", "cumsum"):
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r}")
    return "cumsum" if cfg.moe_dispatch == "cumsum" else "sort"


def top_k(probs, k: int):
    """(gates, ids) [T, k]: the k largest, ties to the lower index (as
    ``jax.lax.top_k``)."""
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[:, :k], ids[:, :k]


def ranks(flat_ids, n_experts: int, how: str):
    """Each assignment's position within its expert's run, in assignment
    order: the reference's ``cumsum`` baseline or its sort dispatch."""
    if how == "cumsum":
        onehot = torch.nn.functional.one_hot(flat_ids, n_experts)
        ranks_all = torch.cumsum(onehot, dim=0) - onehot
        return ranks_all.gather(1, flat_ids[:, None])[:, 0]
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(sorted_ids, torch.arange(
        n_experts, dtype=flat_ids.dtype, device=flat_ids.device))
    rank = torch.empty_like(flat_ids)
    rank[order] = torch.arange(n, dtype=flat_ids.dtype,
                               device=flat_ids.device) - starts[sorted_ids]
    return rank


def route_tokens(router, xt, cfg):
    """Top-k routing of tokens [T, D] -> (gates, ids [T, k], the Switch
    aux loss E * sum_e f_e * p_e over these tokens)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ router.to(xt.dtype)).to(torch.float32)        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(ids, e).to(torch.float32).sum(1).mean(0)
    return gates, ids, cfg.router_aux_coef * e * (me * ce).sum()


def pack(xt, ids, cfg, ep: int = 1, how: str = "sort"):
    """Each kept assignment's token row at slot ``id * C + rank`` of
    ``[E * C, D]`` (C = :func:`capacity` over these T tokens), split by
    owner ``e // (E / ep)`` -> (slots [ep, E / ep * C, D], keep, dest, C)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, t)
    flat_ids = ids.reshape(t * k)
    rank = ranks(flat_ids, e, how)
    keep = rank < c
    dest = torch.where(keep, flat_ids * c + rank,
                       torch.full_like(flat_ids, e * c))       # drop slot
    src = xt.repeat_interleave(k, dim=0)                       # [T*k, D]
    buf = xt.new_zeros((e * c + 1, d)).index_add_(0, dest, src)[:e * c]
    return buf.reshape(ep, (e // ep) * c, d), keep, dest, c


def run_experts(slots, w_gate, w_in, w_out, c: int):
    """Slots [ep, E_loc * C, D] from ep senders through the E_loc experts'
    SwiGLU (``w_*`` [E_loc, ...]) -> the results in the same layout."""
    ep, _, d = slots.shape
    e_loc = w_gate.shape[0]
    dt = slots.dtype
    buf = slots.reshape(ep, e_loc, c, d).transpose(0, 1) \
        .reshape(e_loc, ep * c, d)                         # senders merged
    h = torch.nn.functional.silu(torch.bmm(buf, w_gate.to(dt))) \
        * torch.bmm(buf, w_in.to(dt))
    out = torch.bmm(h, w_out.to(dt))
    return out.reshape(e_loc, ep, c, d).transpose(0, 1) \
        .reshape(ep, e_loc * c, d)


def combine(slots, keep, dest, gates, c: int, cfg):
    """Result slots [ep, E / ep * C, D] -> out [T, D]: the kept
    assignments' rows, weighted by their gates, summed over the k."""
    e, k = cfg.n_experts, cfg.top_k
    d = slots.shape[-1]
    out_buf = slots.reshape(e * c, d)
    gathered = torch.where(keep[:, None],
                           out_buf[torch.clamp(dest, max=e * c - 1)],
                           torch.zeros((), dtype=slots.dtype,
                                       device=slots.device))
    weighted = gathered * gates.reshape(-1, 1).to(slots.dtype)
    return weighted.reshape(-1, k, d).sum(1)


def dense_dispatch(weights, cfg, xt):
    """The dense dispatch of tokens [T, D] over these tokens alone:
    ``weights`` ``(router, moe_wgate, moe_win, moe_wout)`` -> (out [T, D],
    aux, keep [T * k]). It is the all-to-all's stages on one rank."""
    router, w_gate, w_in, w_out = weights
    gates, ids, aux = route_tokens(router, xt, cfg)
    slots, keep, dest, c = pack(xt, ids, cfg, 1, dispatch(cfg))
    out = run_experts(slots, w_gate, w_in, w_out, c)
    return combine(out, keep, dest, gates, c, cfg), aux, keep


class MoE(Leaves):
    """Router [D, E] and per-expert SwiGLU weights [E, D, F] / [E, F, D]
    (the reference's ``init_moe``); every method takes ``over``, leaves that
    replace the module's own (a restacked expert deployment)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        kw = dict(generator=generator, device=device, dtype=cfg.pdtype())
        self.router = nn.Parameter(dense_init((d, e), **kw))
        self.moe_win = nn.Parameter(dense_init((e, d, f), **kw))
        self.moe_wgate = nn.Parameter(dense_init((e, d, f), **kw))
        self.moe_wout = nn.Parameter(dense_init((e, f, d), **kw))

    def forward(self, x, over: Mapping = {}
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,S,D] -> (out [B,S,D], the aux load-balancing loss): the
        all-to-all where :func:`moe_a2a.route` picks it, else the dense
        dispatch over the global batch."""
        from repro_torch.models import moe_a2a
        weights = tuple(self.w(n, over) for n in
                        ("router", "moe_wgate", "moe_win", "moe_wout"))
        if moe_a2a.route(self.cfg, x.shape[0], x.shape[1]):
            return moe_a2a.apply_moe_a2a(weights, self.cfg, x)
        rows = shlib.rows_mesh()
        mine = slice(None)
        if rows is not None and shlib.batch_ranks(rows) > 1:
            mine = shlib.batch_rows(x.shape[0] * shlib.batch_ranks(rows),
                                    rows)
            x = shlib.gather_rows(x, rows)
        b, s, d = x.shape
        out, aux, _ = dense_dispatch(weights, self.cfg, x.reshape(b * s, d))
        return out.reshape(b, s, d)[mine], aux
