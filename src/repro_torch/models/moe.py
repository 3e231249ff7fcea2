"""Mixture-of-Experts layer, dense dispatch (port of ``repro/models/moe.py``
on one device).

Assignments are ranked per expert (by a stable sort, or by the one-hot
``cumsum`` baseline), scattered into an ``[E, C, D]`` buffer of capacity C
per expert, run through per-expert SwiGLU products and gathered back.
``moe_dispatch="a2a"`` is the reference's all-to-all under a mesh; without
one (as here) it falls back to the sort dispatch, as the reference does.
The mesh's all-to-all waits for the multi-GPU slice (ROADMAP Queue 1 item
14b).

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


def dispatch(cfg, mesh=None) -> str:
    """The ranking a MoE layer uses: ``"cumsum"``, or the sort dispatch
    (``"sort"``, and ``"a2a"`` without a mesh, as the reference falls
    back). The all-to-all over a mesh waits for the multi-GPU slice."""
    if cfg.moe_dispatch not in ("a2a", "sort", "cumsum"):
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r}")
    if cfg.moe_dispatch == "a2a" and mesh is not None:
        raise NotImplementedError("the all-to-all MoE dispatch over a mesh "
                                  "waits (ROADMAP Queue 1 item 14b)")
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
        """x [B,S,D] -> (out [B,S,D], the aux load-balancing loss)."""
        cfg = self.cfg
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        t = b * s
        dt = x.dtype
        W = lambda name: self.w(name, over).to(dt)      # noqa: E731
        xt = x.reshape(t, d)
        logits = (xt @ W("router")).to(torch.float32)             # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gates, ids = top_k(probs, k)
        gates = gates / gates.sum(-1, keepdim=True)

        # aux loss (Switch-style): E * sum_e f_e * p_e
        me = probs.mean(0)
        ce = torch.nn.functional.one_hot(ids, e).to(torch.float32).sum(1) \
            .mean(0)
        aux = cfg.router_aux_coef * e * (me * ce).sum()

        flat_ids = ids.reshape(t * k)
        rank = ranks(flat_ids, e, dispatch(cfg))
        c = capacity(cfg, t)
        keep = rank < c
        dest = torch.where(keep, flat_ids * c + rank,
                           torch.full_like(flat_ids, e * c))   # drop slot

        # dispatch: each kept assignment owns one row of [E*C(+1), D]
        src = xt.repeat_interleave(k, dim=0)                       # [T*k, D]
        buf = xt.new_zeros((e * c + 1, d)).index_add_(0, dest, src)
        buf = buf[:e * c].reshape(e, c, d)
        h = torch.nn.functional.silu(torch.bmm(buf, W("moe_wgate"))) \
            * torch.bmm(buf, W("moe_win"))
        out_buf = torch.bmm(h, W("moe_wout")).reshape(e * c, d)

        # combine: gather + gate-weighted sum over the k assignments
        gathered = torch.where(keep[:, None],
                               out_buf[torch.clamp(dest, max=e * c - 1)],
                               torch.zeros((), dtype=dt, device=x.device))
        weighted = gathered * gates.reshape(t * k, 1).to(dt)
        return weighted.reshape(t, k, d).sum(1).reshape(b, s, d), aux
