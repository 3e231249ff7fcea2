"""The training loop (port of ``repro/training/loop.py``).

``run_training`` trains for ``run.steps`` steps with the straggler watchdog
and returns a :class:`TrainResult`. Modes: ``off`` (plain training) and
``align`` / ``cim`` (frozen-exponent training; the projection lives in the
step). Under ``cim`` with ``inject='dynamic'`` and a BER, the paper's Fig. 7
schedule (:func:`repro_torch.core.deployment.training_fault_schedule`)
corrupts the parameters before every step, drawn through K4 on the card
from the step seed ``fold_seed(run.seed + 17, step)``, so a resumed run
draws what the uninterrupted one would have. ``run.grad_compression``
compresses each gradient to int8 with error feedback.

Checkpoints. With a non-empty ``run.checkpoint_dir`` the state is saved
there asynchronously every ``run.checkpoint_every`` steps and at the end
(:mod:`repro_torch.distributed.checkpoint`), and a run given no ``state``
resumes from the latest saved step (``info["resumed_from"]``). A
:class:`~repro_torch.data.synthetic.CheckpointableLoader` as ``batches``
has its cursor saved beside the state and restored with it, so the resumed
run consumes the batches the interrupted one would have.

A device mesh (``mesh=``, a ``("data", "model")`` mesh of
:mod:`repro_torch.launch.mesh`) makes the run data-parallel with the state
replicated, as the reference's: every rank holds the same state (checked
bitwise once, at the start), draws the same global batch from ``batches``
(so a :class:`CheckpointableLoader`'s cursor is the same on every rank)
and keeps its rows when the batch axes divide the batch, else runs it
whole; the step sums the gradient over the mesh
(:func:`repro_torch.training.steps.make_train_step`), so AdamW, the
projection and the Fig. 7 schedule run identically on every rank and each
rank's faulty weights are bitwise the one-device run's. The loop does not
set the ambient mesh (nor does the reference's): a MoE layer takes the
dense dispatch over the global batch unless the caller sets it
(``sharding.use_mesh``), which routes it through the all-to-all over
``"model"``; otherwise ``"model"`` replicates. Checkpoints: rank 0 writes,
every rank waits for the last write at a barrier, and every rank restores.

ZeRO-3 (``shard=True``, or a sharded ``state``): each rank holds its
blocks of the state (:mod:`repro_torch.training.zero3`). A run given no
state initialises them leaf by leaf on the mesh, or restores them: every
checkpoint holds the global leaves (rank 0 gathers one leaf at a time to
the host and writes the replicated run's format), and a restore cuts each
rank's blocks by the target mesh's specs, so any checkpoint restores onto
any mesh and onto one device. The Fig. 7 schedule draws each block at its
offsets, bitwise its region of the one-device draw.

The reference draws the Fig. 7 faults from ``jax.random``; the port's are
the counter PRNG's, so the two agree in rates, not in bits.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.cim import fold_seed
from repro_torch.core.deployment import training_fault_schedule
from repro_torch.data.synthetic import CheckpointableLoader
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.elastic import StragglerWatchdog
from repro_torch.training import steps as steps_lib


FAULT_SEED_OFFSET = 17


def make_fault_schedule(run: RunConfig):
    """Per-step weight corruption for dynamic injection, or None (ber 0,
    static injection, or a mode other than ``cim``)."""
    return training_fault_schedule(run.rel)


def step_seed(run: RunConfig, step: int) -> int:
    """The fault schedule's seed of ``step``: a pure function of the run's
    seed and the step index, as the reference's
    ``fold_in(PRNGKey(seed + 17), step)``."""
    return fold_seed(run.seed + FAULT_SEED_OFFSET, step)


@dataclasses.dataclass
class TrainResult:
    """Result of :func:`run_training`; iterates as ``(state, history,
    info)``. ``deployment`` packs the final weights onto the emulated macro
    under the run's policy (None unless the resolved mode is 'cim');
    ``ecc_stats`` is its stored-bit accounting plus its ECC counters."""

    state: steps_lib.TrainState
    history: List[Dict]
    info: Dict
    cfg: ModelConfig
    run: RunConfig

    def __iter__(self):
        return iter((self.state, self.history, self.info))

    @functools.cached_property
    def deployment(self):
        rel = self.run.rel
        if rel.mode != "cim":
            return None
        from repro_torch.core import deployment as dep_lib
        return dep_lib.CIMDeployment.deploy(self.state.params, rel.policy)

    @property
    def ecc_stats(self) -> Dict:
        dep = self.deployment
        if dep is None:
            return {}
        out = dict(dep.bit_cost())
        out.update({k: int(v) for k, v in dep.ecc_stats.items()})
        return out

    @property
    def final_loss(self) -> float:
        return float(self.history[-1]["loss"]) if self.history else float("nan")


def _on_device(batch: Dict, device: torch.device) -> Dict:
    """Token and label arrays as int64, stub embeddings as float32."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        out[k] = v.to(device=device, dtype=torch.float32
                      if v.is_floating_point() else torch.int64)
    return out


_STATE_FIELDS = ("params", "opt", "exps", "signs", "ef_error")


def _checkpoint_tree(state: steps_lib.TrainState, loader) -> dict:
    tree = {f: getattr(state, f) for f in _STATE_FIELDS}
    if loader is not None:
        tree["data"] = loader.state_dict()
    return tree


def _state_tensors(state: steps_lib.TrainState) -> list:
    trees = (state.params, state.opt["m"], state.opt["v"],
             {"step": state.opt["step"]}, state.exps, state.signs,
             state.ef_error or {})
    return [t for tree in trees for t in tree.values() if t is not None]


def _save(checkpointer, state, loader, step: int, mesh) -> None:
    """Queue a checkpoint of ``state`` at ``step`` on the writer (rank 0's;
    None elsewhere). A sharded state is gathered first, one leaf at a time,
    into host copies on rank 0: every rank takes part."""
    if state.shards is not None:
        from repro_torch.launch import specs
        state = specs.gather_state(state, mesh, dst=0)
        if checkpointer is not None:
            checkpointer.save_async(_checkpoint_tree(state, loader), step,
                                    copy=False)
    elif checkpointer is not None:
        checkpointer.save_async(_checkpoint_tree(state, loader), step)


def run_training(cfg: ModelConfig, run: RunConfig, batches: Iterable[Dict],
                 log_fn: Optional[Callable[[int, Dict], None]] = None,
                 state: Optional[steps_lib.TrainState] = None,
                 mesh=None, *, device=None, shard: bool = False,
                 sleep_injector: Optional[Callable[[int], float]] = None
                 ) -> TrainResult:
    """Train for ``run.steps`` steps. Without ``state``, the run resumes
    from ``run.checkpoint_dir``'s latest step if there is one, else weights
    come from ``torch.Generator(device).manual_seed(run.seed)``; either way
    on ``device`` (default ``cuda``; it raises without a card). With a
    ``state``, the run goes on the device its parameters lie on.
    ``batches`` yields ``tokens`` / ``labels`` arrays (numpy or tensors).
    History entries hold ``loss``, ``accuracy``, ``tokens``, ``grad_norm``,
    ``lr``, ``aux_loss``, ``step`` and ``step_time`` (seconds, after a
    device synchronize). ``sleep_injector(step)`` seconds are slept inside
    a step's timing (simulated host slowness, for the watchdog). ``mesh``
    makes the run data-parallel (module doc); ``shard`` (or a sharded
    ``state``) shards the state over it (ZeRO-3)."""
    if mesh is not None and tuple(getattr(mesh, "mesh_dim_names", None)
                                  or ()) != ("data", "model"):
        raise ValueError(f"run_training: mesh must be a ('data', 'model') "
                         f"DeviceMesh (launch.mesh.make_host_mesh), got "
                         f"{mesh!r}")
    shard = shard or (state is not None and state.shards is not None)
    if shard and mesh is None:
        raise ValueError("run_training: a sharded state needs its mesh")
    corrupt = make_fault_schedule(run)
    step_fn = steps_lib.make_train_step(cfg, run, mesh)
    loader = batches if isinstance(batches, CheckpointableLoader) else None
    writer = mesh is None or torch.distributed.get_rank() == 0
    start_step, checkpointer = 0, None
    if run.checkpoint_dir:
        os.makedirs(run.checkpoint_dir, exist_ok=True)
        if state is None and \
                ckpt_lib.latest_step(run.checkpoint_dir) is not None:
            dev = resolve_device(device)
            tree, start_step = ckpt_lib.restore(
                None, run.checkpoint_dir, device="cpu" if shard else dev)
            state = steps_lib.TrainState(**{f: tree[f]
                                            for f in _STATE_FIELDS})
            if shard:
                from repro_torch.launch import specs
                state = specs.shard_state(state, mesh,
                                          steps_lib.group_rows(run),
                                          device=dev)
            # the step count lives on the host, where init_opt_state puts
            # it: the lr schedule and bias corrections are computed there
            state.opt["step"] = state.opt["step"].cpu()
            if run.grad_compression != (state.ef_error is not None):
                raise ValueError(
                    f"checkpoint step {start_step} in {run.checkpoint_dir!r} "
                    f"was saved {'without' if run.grad_compression else 'with'}"
                    f" gradient compression, which this run "
                    f"{'asks for' if run.grad_compression else 'turns off'}")
            if loader is not None and "data" in tree:
                loader.load_state_dict(tree["data"])
        if writer:
            checkpointer = ckpt_lib.AsyncCheckpointer(run.checkpoint_dir)
    if state is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        state = steps_lib.init_train_state(gen, cfg, run, device=dev,
                                           mesh=mesh if shard else None)
    if mesh is not None and not shard and not shlib.same_on_every_rank(
            _state_tensors(state), mesh):
        raise ValueError("run_training on a mesh: the state differs between "
                         "ranks (data parallelism replicates it)")
    dev = next(iter(state.params.values())).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    watchdog = StragglerWatchdog(factor=run.straggler_factor)
    history, stragglers = [], 0
    it = iter(batches)
    try:
        for step in range(start_step, run.steps):
            batch = _on_device(next(it), dev)
            sync()
            t0 = time.perf_counter()
            if sleep_injector is not None:
                time.sleep(sleep_injector(step))
            if corrupt is not None:
                # the step trains on the faulty weights, as the reference's
                state = dataclasses.replace(state, params=corrupt(
                    state.params, step_seed(run, step),
                    *(() if state.shards is None
                      else (state.shards.params,))))
            state, metrics = step_fn(state, batch)
            sync()
            dt = time.perf_counter() - t0
            metrics = {k: float(v) for k, v in metrics.items()}
            # the first step is the warm-up: never fed to the watchdog
            if step > start_step and watchdog.observe(dt):
                stragglers += 1
            metrics.update(step=step, step_time=dt)
            history.append(metrics)
            if log_fn:
                log_fn(step, metrics)
            if run.checkpoint_dir and (step + 1) % run.checkpoint_every == 0:
                _save(checkpointer, state, loader, step + 1, mesh)
        if run.checkpoint_dir:
            _save(checkpointer, state, loader, run.steps, mesh)
        if checkpointer:
            checkpointer.wait()
    finally:
        if checkpointer:
            checkpointer.close()
    if mesh is not None and run.checkpoint_dir:
        shlib.barrier(mesh)     # rank 0's last write is on disk for all
    info = {"stragglers_flagged": stragglers, "resumed_from": start_step,
            "ewma_step_time": watchdog.ewma}
    return TrainResult(state=state, history=history, info=info, cfg=cfg,
                       run=run)
