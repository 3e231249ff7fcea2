"""The train step with the reliability feature wired in, and the serving
engine's step factories (port of ``repro/training/steps.py``).

A step is: forward -> loss -> gradient -> global-norm clip -> (optional int8
error-feedback compression of the gradient) -> AdamW -> frozen-exponent
projection (paper §III-C: mantissa-only updates). The
parameters are a ``{path: tensor}`` tree in the reference's layout and
flatten order, so each gradient, moment, frozen exponent and frozen sign
matches one leaf of the reference one to one.

Data parallelism (``mesh``): every rank holds the same state and the same
global batch, keeps its rows when the batch axes divide the batch (else
runs the whole batch) and differentiates its share of the global loss, so
that the gradient summed over the mesh's ranks is the one-device gradient
of the one-device loss: the masked NLL sum over the global token count
(:func:`lm_loss_sums`, the counts summed over the batch axes), weighted
by one over the ranks that hold the same rows; the MoE aux (global, or
each rank's local aux under the all-to-all) and the regularizer weighted
by one over every rank. The sum runs over the whole mesh before the clip
and the compression, so AdamW, the projection and the next step's faults
are identical on every rank.

ZeRO-3 (a state whose ``shards`` are set, :func:`repro_torch.launch.specs.
shard_state` or :func:`init_train_state` with a ``mesh``): each rank holds
its blocks of every leaf; the forward gathers a layer group's leaves just
before the group computes, the backward reduce-scatters each weight
gradient onto its owners' blocks, and everything after the gradient runs
on the blocks (:mod:`repro_torch.training.zero3`). The loss weighting is
the data-parallel one above; the regularizer's gradient on a block is its
own term (no sum over the mesh follows it).

Memory: the step owns its gradients and scales them in place when it
clips. On a replicated state AdamW builds new parameter and moment trees
beside the old ones, so the state a caller passed stays as it was; its
temporaries and the projection's are one leaf's at a time. The sharded
step updates the state it is given in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import align as align_lib
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.compression import compress_decompress
from repro_torch.models import lm
from repro_torch.models.losses import (exponent_compression_penalty,
                                       lm_loss_sums)
from repro_torch.optim import adamw
from repro_torch.training import zero3

@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: dict                     # {"m": tree, "v": tree, "step": int32 0-dim}
    exps: Dict[str, Optional[torch.Tensor]]    # frozen block exponents
    signs: Dict[str, Optional[torch.Tensor]]   # frozen signs (int8)
    ef_error: Optional[dict] = None            # grad compression residuals
    # ZeRO-3: the layouts of the blocks the trees hold (a TrainState of
    # {path: Layout} trees, launch.specs.state_shardings); None when the
    # trees hold the global leaves
    shards: Optional["TrainState"] = None


def group_rows(run: RunConfig):
    """-> ``path -> n_group``: the exponent group of each leaf under the
    run's policy (8 where none applies), which a shard keeps whole."""
    rel = run.rel
    if not (rel.enabled() and rel.policy is not None):
        return lambda path: 8
    return lambda path: rel.policy.rule_for(path).n_group


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     run: RunConfig, params=None, *, device=None,
                     mesh=None) -> TrainState:
    """A fresh state (new optimizer): weights from ``generator`` (an
    :class:`LM` built on ``device``), or the given ``params`` tree; aligned
    and frozen when the run's reliability is on and ``freeze_exponents``;
    with ``grad_compression`` a zero float32 error-feedback residual per
    leaf. With a ``mesh`` the state is this rank's ZeRO-3 blocks: drawn
    leaf by leaf from ``generator`` and cut as they come
    (:func:`zero3.init_blocks`), or cut from ``params``; they are bitwise
    the blocks of the one-device state."""
    from repro_torch.launch import specs
    rows = group_rows(run)
    layouts = None
    if mesh is not None:
        if params is None:
            params, layouts = zero3.init_blocks(cfg, generator, device, mesh,
                                                n_group=rows)
        else:
            layouts = specs.param_shardings_sane(mesh, params, n_group=rows)
            params = {p: layouts[p].cut(w).clone() for p, w in params.items()}
    elif params is None:
        from repro_torch import convert
        model = lm.LM(cfg, generator=generator, device=device)
        params = convert.flat_from_lm(model)
        del model
    rel = run.rel
    exps = signs = {p: None for p in params}
    if rel.enabled() and run.freeze_exponents:
        params, exps = align_lib.align_pytree_policy(params, rel.policy)
        signs = {p: None if exps[p] is None
                 else torch.sign(w).to(torch.int8)
                 for p, w in params.items()}
    ef = None
    if run.grad_compression:
        ef = {p: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              for p, w in params.items()}
    state = TrainState(params=dict(params),
                       opt=adamw.init_opt_state(params), exps=exps,
                       signs=signs, ef_error=ef)
    if layouts is not None:
        state.shards = specs.state_shardings(
            mesh, specs.abstract_state(state, layouts), rows)
    return state


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    mesh=None) -> Callable:
    """-> ``train_step(state, batch) -> (state, metrics)``. ``batch`` holds
    ``tokens`` and ``labels`` [B, S] tensors on the parameters' device (and
    a stub modality's ``vision_embeds`` or ``embeds``, :func:`batches_for`);
    metrics are 0-dim tensors (``loss``, ``accuracy``, ``tokens``,
    ``grad_norm``, ``lr``, ``aux_loss``, and ``exp_penalty`` with the
    regularizer). A state with ``ef_error`` compresses its clipped gradient
    (int8 with error feedback) before AdamW. With a ``("data", "model")``
    ``mesh`` the step is data-parallel (module doc): ``batch`` is the
    global batch on every rank, and the metrics are the global batch's."""
    rel = run.rel
    project = rel.enabled() and run.freeze_exponents
    reg_policy = rel.policy if run.exp_reg_coef > 0 else None
    opt_cfg = adamw.AdamWConfig(weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    lr_fn = adamw.make_lr_schedule(run.learning_rate, run.warmup_steps,
                                   run.steps)
    cdt = cfg.cdtype()
    model = lm.shell(cfg)

    def _cast(p):
        # weights to the compute dtype once at the step top (a no-op for
        # fp32 olmo); gradients come back in the parameters' dtype
        if p.ndim >= 2 and p.is_floating_point():
            return p.to(cdt)
        return p

    ranks = 1 if mesh is None else mesh.size()

    def loss_fn(params, batch, rows_mesh, replicas, shards, gather):
        """This rank's share of the loss (module doc; the loss itself on
        one device: dividing by one is exact)."""
        params_c = {k: _cast(v) for k, v in params.items()}
        logits, aux = lm.forward_blocks(model, params_c, batch,
                                        remat=run.remat, gather=gather)
        nll, hits, tokens = lm_loss_sums(logits, batch["labels"])
        del logits
        total = nll.detach()
        if rows_mesh is not None:       # the global batch's sums
            hits, tokens = shlib.sum_over_batch(torch.stack([hits, tokens]),
                                                rows_mesh)
            total = shlib.sum_over_batch(total, rows_mesh)
        denom = tokens.clamp(min=1)
        loss = nll / denom / replicas
        metrics = {"loss": total / denom, "accuracy": hits / denom,
                   "tokens": denom}
        if reg_policy is not None:
            # on blocks, each block's own term: no sum over the mesh follows
            pen = exponent_compression_penalty(
                params, reg_policy, margin=run.exp_reg_margin,
                layouts=None if shards is None else shards.params,
                total=zero3.leaf_total(mesh))
            loss = loss + run.exp_reg_coef * pen / (
                ranks if shards is None else 1)
            metrics = dict(metrics, exp_penalty=pen)
        if gather is not None:
            metrics = dict(metrics, gathered_bytes=torch.tensor(
                float(gather.bytes)))
        return loss + aux / ranks, (metrics, aux)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        shards = state.shards
        if shards is not None and mesh is None:
            raise ValueError("train_step: a sharded state needs the mesh it "
                             "is sharded over (make_train_step(mesh=))")
        rows = shlib.batch_rows(batch["tokens"].shape[0], mesh) \
            if mesh is not None else slice(None)
        split = rows != slice(None)
        if split:
            batch = {k: v[rows] for k, v in batch.items()}
        replicas = ranks // shlib.batch_ranks(mesh) if split else ranks
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        gather = None if shards is None else \
            zero3.leaf_gather(shards.params, mesh)
        with torch.enable_grad(), shlib.split_rows(mesh if split else None):
            total, (metrics, aux) = loss_fn(leaves, batch,
                                            mesh if split else None, replicas,
                                            shards, gather)
            # an audio_stub batch leaves the embed unread: its gradient is
            # zero, as jax.grad's
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        grads = {p: torch.zeros_like(w) if g is None else g
                 for (p, w), g in zip(leaves.items(), grads)}
        del total, leaves
        if gather is not None:
            grads = gather.settle(grads)
        elif ranks > 1:
            for g in grads.values():
                shlib.all_reduce_mesh(g, mesh)
        metrics = {k: v.detach() for k, v in metrics.items()}
        aux = aux.detach()
        grads, gnorm = adamw.clip_by_global_norm(
            grads, opt_cfg.grad_clip, norm=None if shards is None else
            zero3.global_norm(grads, shards.params, mesh))
        ef = state.ef_error
        if ef is not None:
            grads, ef = compress_decompress(
                grads, ef, None if shards is None else zero3.leaf_max(mesh))
        lr = lr_fn(state.opt["step"])
        params, opt = adamw.adamw_update(grads, state.opt, state.params, lr,
                                         opt_cfg, in_place=shards is not None)
        del grads
        if project:     # AdamW's fresh weights, or the blocks, in place
            params = align_lib.project_in_place(params, state.exps,
                                                state.signs, rel.policy)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr, aux_loss=aux)
        return TrainState(params, opt, state.exps, state.signs, ef,
                          shards), metrics

    return train_step


# ---------------------------------------------------------------------------
# Continuous-batching engine steps (the reference jits these; the port calls
# them eagerly). ``model`` is the serving :class:`~repro_torch.models.lm.LM`.
# ---------------------------------------------------------------------------


def make_prefill_chunk_step(model: "lm.LM") -> Callable:
    """One prompt chunk of one slot appended to the engine's slot states."""
    def prefill_chunk_step(params, caches, tokens, slot, pos, length,
                           req_salt):
        return model.prefill_chunk(caches, tokens, slot, pos, length,
                                   req_salt, params=params)
    return prefill_chunk_step


def make_decode_slots_step(model: "lm.LM") -> Callable:
    """One decode token across the slot batch, with per-slot positions and
    per-request fault-stream salts."""
    def decode_slots_step(params, caches, tokens, active, req_salts):
        return model.decode_slots(caches, tokens, active, req_salts,
                                  params=params)
    return decode_slots_step


def make_extract_state_step(cfg: ModelConfig) -> Callable:
    """Prefix cache: one slot's state chunk after a prefill."""
    def extract_state_step(caches, slot, pos, length):
        return lm.extract_state_chunk(cfg, caches, slot, pos, length)
    return extract_state_step


def make_inject_state_step(cfg: ModelConfig) -> Callable:
    """Prefix cache: write a cached state chunk into a slot."""
    def inject_state_step(caches, slot, pos, chunk):
        return lm.inject_state_chunk(cfg, caches, slot, pos, chunk)
    return inject_state_step
