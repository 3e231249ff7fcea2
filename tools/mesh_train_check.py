#!/usr/bin/env python3
"""Data-parallel training and the MoE all-to-all on four cards, held to one
card.

  python3 -c 'import sys; sys.path.insert(0, "src"); from repro_torch.kernels.fault_inject import kernel; kernel.LIBRARY.build()'
  torchrun --nproc-per-node 4 tools/mesh_train_check.py [--json PATH]

(build K3/K4 once first: the ranks would each run nvcc). Every rank builds
the same seeded weights on its card.

(a) One aligned step (one4n rule, lr 1e-3) through ``run_training(mesh=)``
    on reduced olmo-1b over 4x1 and 2x2, and on reduced qwen3-moe with the
    all-to-all over "model" (the mesh set as the ambient one) over 2x2 and
    1x4, against the same step on rank 0's card alone (the all-to-all's
    ranks all run there: ``moe_a2a.apply_moe_a2a_local``): loss, accuracy,
    aux and grad norm within 1e-4 relative, gradients (AdamW's first
    moment, 0.1 g) within allclose(1e-4, 1e-5 of the leaf's largest),
    parameters within one fp16 ulp where the gradient exceeds 1e-6, and
    every rank's state bitwise rank 0's. The batch is 4 x 16 with
    IGNORE-masked labels, 12 of 64, unevenly over the rows.
(b) Full-width olmo-1b under the Fig. 7 schedule (one4n, BER 1e-4,
    dynamic, K4): 8 aligned steps on one card at 8 x 128, then on 4x1 at
    32 x 128 (8 rows a card); step ms by CUDA events (step 0 is the
    warm-up), tokens/s and each card's peak ``max_memory_allocated``;
    every rank's state bitwise rank 0's.
(c) qwen3-moe at its published widths, cut to 4 of its 94 layers (~45 GB
    of fp32 weights, so one card holds the one-card reference):
    the forward of a 4 x 256 batch on 1x4 with the all-to-all against the
    emulated per-slice dense dispatch on rank 0's card (logits within 1e-4
    of their largest), the MoE layer's forward ms on the mesh (CUDA
    events, rank 0) beside the emulated layer's on one card, and the
    exchanges' share: the layer's two all-to-alls, its all-gather and its
    aux all-reduce timed alone at the layer's shapes.

(d) ZeRO-3 (the state sharded over the mesh, ``run_training(shard=True)``):
    reduced granite-3-8b, one aligned step sharded on 4x1 and on 2x2
    against the same step on rank 0's card (part (a)'s tolerances); its
    2x2 run under the schedule (BER 1e-3), checkpointed every step and
    interrupted in step 2, resumed on 4x1, on a 2x1 mesh emulated on rank
    0's card (``zero3.emulate_step``) and on one card, each step-2 loss
    within 1e-4 of the uninterrupted run's; then full-width granite-3-8b
    (8.37 G parameters, ~134 GB of fp32 state with AdamW's moments) on
    4x1 at 8 x 128 (2 rows a card), ``--d-steps`` aligned steps under the
    Fig. 7 schedule at BER 1e-4: step ms by CUDA events, each card's peak
    ``max_memory_allocated``, the gathered bytes a step and the share of
    a step the current stream waits in gathers and reduce-scatters
    (``zero3.time_collectives``).

Rank 0 prints one JSON line a part, then the card's name and power limit,
and with ``--json PATH`` writes them all to PATH. Exits 1 if a check fails.
``--parts`` picks parts (default ``abcd``). Each rank logs its steps and
the part it is in to ``--log-dir`` (``rank{r}.log``), with a Python stack
dump of every thread when a part outlives ``--stack-after`` seconds, and
the process group times out a collective after ``--pg-timeout`` seconds
(NCCL's watchdog then names the collective); a rank that fails prints its
traceback and leaves without tearing the group down (tearing down under a
collective that never completes blocks).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

import chip_timing

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen3-moe-235b-a22b"
RTOL, ATOL, GRAD_FLOOR = 1e-4, 1e-5, 1e-6
REDUCED = (("olmo-1b", "4x1", False), ("olmo-1b", "2x2", False),
           (QWEN, "2x2", True), (QWEN, "1x4", True))
FULL_STEPS, FULL_SEQ, CARD_ROWS = 8, 128, 8
GRANITE = "granite-3-8b"
D_ROWS = 2                   # granite's rows a card at full width
LOG = None                   # this rank's log file
QWEN_LAYERS, QWEN_BATCH, QWEN_SEQ = 4, 4, 256
MOE_LEAVES = ("router", "moe_wgate", "moe_win", "moe_wout")


def _fp16_ulps(a, b):
    import torch
    ha = a.to(torch.float16).view(torch.int16).to(torch.int32)
    hb = b.to(torch.float16).view(torch.int16).to(torch.int32)
    return (ha - hb).abs()


@contextlib.contextmanager
def _in_process(data, model):
    """MoE layers take the all-to-all of a ``data x model`` mesh with every
    rank run on this card (``moe_a2a.apply_moe_a2a_local``): the one-card
    reference of the mesh's all-to-all."""
    from unittest import mock
    from repro_torch.models import moe_a2a

    def local(weights, cfg, x):
        return moe_a2a.apply_moe_a2a_local(weights, cfg, x, data, model)[:2]
    with mock.patch.object(moe_a2a, "route", lambda *_: True), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", local):
        yield


def _run(**kw):
    from repro_torch.configs import RunConfig
    from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy
    base = dict(steps=1, checkpoint_dir="", learning_rate=1e-3,
                warmup_steps=0, policy=ReliabilityPolicy(default=PolicyRule(
                    protect="one4n", n_group=8, index=2)))
    base.update(kw)
    return RunConfig(**base)


def _params(cfg, dev):
    import torch
    from repro_torch import convert
    from repro_torch.models.lm import LM
    model = LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    return convert.flat_from_lm(model)


def _batch(cfg):
    import numpy as np
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models.losses import IGNORE
    b = MarkovLM(cfg.vocab_size, 16, 4, seed=3).batch(0)
    labels = np.array(b["labels"])
    labels[0, :9] = IGNORE
    labels[-1, 5:8] = IGNORE
    return {"tokens": b["tokens"], "labels": labels}


def _step(cfg, dev, mesh, a2a):
    """One aligned step -> (metrics, params, first moments)."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.training import loop, steps
    run = _run()
    state = steps.init_train_state(None, cfg, run, params=_params(cfg, dev))
    with shlib.use_mesh(mesh if a2a else None):
        res = loop.run_training(cfg, run, iter([_batch(cfg)]), state=state,
                                mesh=mesh)
    return res.history[0], res.state.params, res.state.opt["m"]


def _held(got, want) -> dict:
    """The worst of each tolerance: metrics, gradients, parameters."""
    import torch
    (gm, gp, gg), (wm, wp, wg) = got, want
    out = {"metrics": max(abs(gm[k] - wm[k]) / (abs(wm[k]) or 1.0)
                          for k in ("loss", "accuracy", "grad_norm",
                                    "aux_loss"))}
    worst_g, worst_u = 0.0, 0
    for p, w in wp.items():
        g, h = gg[p] / 0.1, wg[p] / 0.1
        scale = float(h.abs().max()) or 1.0
        excess = ((g - h).abs() - RTOL * h.abs()) / (ATOL * scale)
        worst_g = max(worst_g, float(excess.max()))
        ulps = _fp16_ulps(gp[p], w)[h.abs() > GRAD_FLOOR]
        worst_u = max(worst_u, int(ulps.max()) if ulps.numel() else 0)
    out["gradient_excess_over_atol"] = worst_g      # <= 1 holds
    out["param_fp16_ulps"] = worst_u
    out["ok"] = out["metrics"] <= RTOL and worst_g <= 1 and worst_u <= 1 \
        and bool(torch.isfinite(torch.tensor(gm["loss"])))
    return out


def part_a(dev, rank0, report) -> bool:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    ok = True
    for arch, spec, a2a in REDUCED:
        cfg = get_config(arch).reduced()
        d, m = (int(v) for v in spec.split("x"))
        want = None
        if rank0:
            if a2a:
                with _in_process(d, m):
                    want = _step(cfg, dev, None, False)
            else:
                want = _step(cfg, dev, None, False)
        dist.barrier()
        mesh = mesh_lib.make_serve_mesh(spec, "cuda")
        got = _step(cfg, dev, mesh, a2a)
        same = shlib.same_on_every_rank(list(got[1].values()), mesh)
        if rank0:
            held = _held(got, want)
            held["same_on_every_rank"] = same
            ok = ok and held["ok"] and same
            line = {"part": "a", "arch": arch, "reduced": True, "mesh": spec,
                    "all_to_all": a2a, "loss": got[0]["loss"],
                    "one_card_loss": want[0]["loss"],
                    "aux_loss": got[0]["aux_loss"], **held}
            report.append(line)
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return ok


def log(*what) -> None:
    """A line in this rank's log (flushed: a hang leaves it readable)."""
    if LOG is not None:
        LOG.write(f"{time.time():.3f} " + " ".join(map(str, what)) + "\n")
        LOG.flush()


class _EventClock:
    """Step times by CUDA events through ``run_training``'s hooks: an event
    as a step starts (``sleep_injector``, which sleeps 0) and one as it
    ends (``log_fn``, after the step's metrics reached the host)."""

    def __init__(self, tag: str):
        self.tag, self.starts, self.ends = tag, [], []

    @staticmethod
    def _event():
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self, step: int) -> float:
        log(self.tag, "step", step, "start")
        self.starts.append(self._event())
        return 0.0

    def end(self, step: int, metrics) -> None:
        self.ends.append(self._event())
        log(self.tag, "step", step, "end", f"loss={metrics['loss']:.6g}")

    def ms(self) -> list:
        self.ends[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.starts, self.ends)]


class _ScheduleClock:
    """CUDA events around each call of the Fig. 7 schedule that
    ``run_training`` makes (``loop.make_fault_schedule`` wrapped)."""

    def __init__(self, make):
        self.make, self.pairs = make, []

    def __call__(self, run):
        corrupt = self.make(run)
        if corrupt is None:
            return None

        def timed(*args, **kwargs):
            start = _EventClock._event()
            out = corrupt(*args, **kwargs)
            self.pairs.append((start, _EventClock._event()))
            return out
        timed.rates = corrupt.rates
        return timed

    def ms(self) -> list:
        if self.pairs:
            self.pairs[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def _full_run(cfg, dev, mesh, rows, tag):
    import torch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import loop, steps
    run = _run(steps=FULL_STEPS, ber=1e-4, inject="dynamic")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(gen, cfg, run, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _EventClock(tag)
    res = loop.run_training(cfg, run, iter(MarkovLM(
        cfg.vocab_size, FULL_SEQ, rows, seed=0)), state=state, mesh=mesh,
        log_fn=clock.end, sleep_injector=clock.start)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = clock.ms()
    steady = statistics.median(ms[1:])
    return res, {"step_ms": ms, "steady_ms": steady,
                 "tokens_per_s": rows * FULL_SEQ / steady * 1e3,
                 "losses": [h["loss"] for h in res.history],
                 "peak_gib": peak}


def part_b(dev, rank0, world, report) -> bool:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_config("olmo-1b")
    one = None
    if rank0:
        res, one = _full_run(cfg, dev, None, CARD_ROWS, "b one card")
        del res
    torch.cuda.empty_cache()
    dist.barrier()
    mesh = mesh_lib.make_serve_mesh(f"{world}x1", "cuda")
    res, figs = _full_run(cfg, dev, mesh, CARD_ROWS * world, f"b {world}x1")
    same = shlib.same_on_every_rank(list(res.state.params.values()), mesh)
    peaks = shlib.all_gather_objects(figs["peak_gib"], "data", mesh)
    del res
    torch.cuda.empty_cache()
    ok = same and all(x == x and abs(x) != float("inf")
                      for x in figs["losses"])
    if rank0:
        line = {"part": "b", "arch": "olmo-1b", "mesh": f"{world}x1",
                "batch": [CARD_ROWS * world, FULL_SEQ], **figs,
                "peak_gib_by_card": peaks, "same_on_every_rank": same,
                "one_card": {"batch": [CARD_ROWS, FULL_SEQ], **one}}
        report.append(line)
        print(json.dumps(line), flush=True)
    return ok


def part_c(dev, rank0, world, report) -> bool:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm, moe_a2a
    cfg = dataclasses.replace(get_config(QWEN), n_layers=QWEN_LAYERS)
    mesh = mesh_lib.make_serve_mesh(f"1x{world}", "cuda")
    model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    gbytes = sum(p.numel() for p in model.parameters()) * 4 / 1e9
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (QWEN_BATCH, QWEN_SEQ),
                         generator=gen, device=dev)
    calls = []
    real = moe_a2a.apply_moe_a2a

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    with torch.no_grad():
        moe_a2a.apply_moe_a2a = counted
        try:
            with shlib.use_mesh(mesh):
                got = model(toks)
        finally:
            moe_a2a.apply_moe_a2a = real
        want = None
        if rank0:
            with _in_process(1, world):
                want = model(toks)
        # one MoE layer alone at the stack's first MoE input
        h = model.embed[toks]
        layer = model.blocks[0].moe
        with shlib.use_mesh(mesh):
            mesh_ms = chip_timing.time_ms(lambda: layer(h), inner=3,
                                          warm=2)
        one_ms = None
        if rank0:
            with _in_process(1, world):
                one_ms = chip_timing.time_ms(lambda: layer(h), inner=3,
                                             warm=2)
        # the layer's exchanges alone, at its shapes
        tl = QWEN_BATCH * QWEN_SEQ // world
        c = max(8, -(-tl * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
        c = int(c)
        send = torch.randn(world, cfg.n_experts // world * c, cfg.d_model,
                           device=dev)
        out_blk = torch.randn(QWEN_BATCH, QWEN_SEQ // world, cfg.d_model,
                              device=dev)
        aux = torch.zeros((), device=dev)

        def exchanges():
            shlib.all_to_all(send, "model", mesh)
            shlib.all_to_all(send, "model", mesh)
            shlib.all_gather(out_blk, "model", mesh, dim=1)
            shlib.all_reduce_mesh(aux.clone(), mesh)
        exch_ms = chip_timing.time_ms(exchanges, inner=3, warm=2)
    ok = len(calls) == QWEN_LAYERS
    if rank0:
        err = float((got - want).abs().max()) / float(want.abs().max())
        ok = ok and err <= RTOL and bool(torch.isfinite(got).all())
        line = {"part": "c", "arch": QWEN, "layers": QWEN_LAYERS,
                "of_layers": 94, "weights_gb": gbytes, "mesh": f"1x{world}",
                "batch": [QWEN_BATCH, QWEN_SEQ], "a2a_calls": len(calls),
                "capacity": c, "logits_rel_err": err,
                "moe_layer_ms_mesh": mesh_ms,
                "moe_layer_ms_one_card_emulated": one_ms,
                "exchanges_ms": exch_ms,
                "exchanges_share": exch_ms / mesh_ms, "ok": ok}
        report.append(line)
        print(json.dumps(line), flush=True)
    del model
    torch.cuda.empty_cache()
    return ok


def _gathered(res, mesh, dev):
    """Rank 0's (metrics, params, first moments) of a sharded run's global
    state, on its card (None elsewhere)."""
    from repro_torch.launch import specs
    whole = specs.gather_state(res.state, mesh, dst=0)
    if whole is None:
        return None
    return (res.history[0],
            {p: w.to(dev) for p, w in whole.params.items()},
            {p: w.to(dev) for p, w in whole.opt["m"].items()})


def _zero3_step(cfg, dev, mesh):
    """One aligned step with the state sharded over ``mesh``."""
    from repro_torch.training import loop, steps
    run = _run()
    state = steps.init_train_state(None, cfg, run, params=_params(cfg, dev),
                                   mesh=mesh)
    res = loop.run_training(cfg, run, iter([_batch(cfg)]), state=state,
                            mesh=mesh, device=dev, shard=True)
    return _gathered(res, mesh, dev)


class _Stop(Exception):
    pass


def _stop_at_2(step, metrics):
    if step == 2:
        raise _Stop


def _ckpt_run(cfg, dev, mesh, ckpt_dir, shard=True, log_fn=None,
              fresh=True):
    """3 steps of reduced granite under the schedule (BER 1e-3), a
    checkpoint every step in ``ckpt_dir`` (none with "")."""
    from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM
    from repro_torch.training import loop, steps
    run = _run(steps=3, ber=1e-3, inject="dynamic", checkpoint_dir=ckpt_dir,
               checkpoint_every=1)
    state = steps.init_train_state(None, cfg, run, params=_params(cfg, dev),
                                   mesh=mesh if shard else None) \
        if fresh else None
    return loop.run_training(cfg, run, CheckpointableLoader(MarkovLM(
        cfg.vocab_size, 16, 4, seed=5)), log_fn=log_fn, state=state,
        mesh=mesh, device=dev, shard=shard)


def _emulated_resume(cfg, dev, ckpt_dir, ranks: int) -> float:
    """The checkpoint's step 2 on a ``ranks`` x 1 mesh emulated on this
    card: each rank's blocks cut from the global leaves, corrupted at
    their offsets, one ``zero3.emulate_step`` (the program's step, a
    thread a rank) -> the step's loss."""
    import dataclasses
    import torch
    from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import specs
    from repro_torch.training import loop, steps, zero3
    run = _run(steps=3, ber=1e-3, inject="dynamic", checkpoint_dir=ckpt_dir,
               checkpoint_every=1)
    tree, start = ckpt_lib.restore(None, ckpt_dir, device="cpu")
    whole = steps.TrainState(**{f: tree[f] for f in loop._STATE_FIELDS})
    meshes = shlib.thread_ranks(("data", "model"), (ranks, 1))
    states = [specs.shard_state(whole, m, steps.group_rows(run), device=dev)
              for m in meshes]
    loader = CheckpointableLoader(MarkovLM(cfg.vocab_size, 16, 4, seed=5))
    loader.load_state_dict(tree["data"])
    batch = loop._on_device(next(iter(loader)), dev)
    corrupt = loop.make_fault_schedule(run)
    states = [dataclasses.replace(s, params=corrupt(
        s.params, loop.step_seed(run, start), s.shards.params))
        for s in states]
    _, metrics = zero3.emulate_step(cfg, run, states, meshes, batch)
    return start, float(metrics["loss"])


def part_d(dev, rank0, world, report, d_steps: int) -> bool:
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import loop, zero3
    ok = True
    cfg = get_config(GRANITE).reduced()
    # (d1) one sharded step on 4x1 and 2x2 against one card
    for spec in ("4x1", "2x2"):
        log("d1", spec)
        want = _step(cfg, dev, None, False) if rank0 else None
        dist.barrier()
        mesh = mesh_lib.make_serve_mesh(spec, dev.type)
        got = _zero3_step(cfg, dev, mesh)
        if rank0:
            held = _held(got, want)
            ok = ok and held["ok"]
            line = {"part": "d", "arch": GRANITE, "reduced": True,
                    "mesh": spec, "sharded": True, "loss": got[0]["loss"],
                    "one_card_loss": want[0]["loss"], **held}
            report.append(line)
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    # (d2) a 2x2 checkpoint resumed on 4x1, an emulated 2x1 and one card
    log("d2")
    base = tempfile.mkdtemp(prefix="zero3_ckpt_") if rank0 else None
    base = _broadcast(base)
    m22 = mesh_lib.make_serve_mesh("2x2", dev.type)
    whole = _ckpt_run(cfg, dev, m22, "")
    try:
        _ckpt_run(cfg, dev, m22, base + "/2x2", log_fn=_stop_at_2)
    except _Stop:
        pass
    dist.barrier()
    if rank0:
        shutil.copytree(base + "/2x2", base + "/4x1")
    dist.barrier()
    m41 = mesh_lib.make_serve_mesh(f"{world}x1", dev.type)
    resumed = _ckpt_run(cfg, dev, m41, base + "/4x1", fresh=False)
    if rank0:
        want = whole.history[2]["loss"]
        two_from, two = _emulated_resume(cfg, dev, base + "/2x2", 2)
        one = _ckpt_run(cfg, dev, None, base + "/2x2", shard=False,
                        fresh=False)
        losses = {"4x1": resumed.history[0]["loss"], "2x1 emulated": two,
                  "one card": one.history[0]["loss"]}
        err = max(abs(v - want) / abs(want) for v in losses.values())
        good = (resumed.info["resumed_from"] == two_from
                == one.info["resumed_from"] == 2 and err <= RTOL)
        ok = ok and good
        line = {"part": "d", "arch": GRANITE, "reduced": True,
                "checkpoint": "2x2 step 2", "uninterrupted_step2_loss": want,
                "resumed_step2_loss": losses, "rel_err": err, "ok": good}
        report.append(line)
        print(json.dumps(line), flush=True)
        shutil.rmtree(base, ignore_errors=True)
    del whole, resumed
    torch.cuda.empty_cache()
    dist.barrier()
    # (d3) full-width granite-3-8b on 4x1
    log("d3")
    full = get_config(GRANITE)
    run = _run(steps=d_steps, ber=1e-4, inject="dynamic")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _EventClock(f"d {world}x1")
    schedule = _ScheduleClock(loop.make_fault_schedule)
    t0 = time.perf_counter()
    with zero3.time_collectives() as timer, \
            mock.patch.object(loop, "make_fault_schedule", schedule):
        res = loop.run_training(
            full, run, iter(MarkovLM(full.vocab_size, FULL_SEQ,
                                     D_ROWS * world, seed=0)),
            mesh=m41, device=dev, shard=True, log_fn=clock.end,
            sleep_injector=clock.start)
    wall = time.perf_counter() - t0
    ms = clock.ms()
    schedule_ms = schedule.ms()
    coll = zero3.collective_ms(timer)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    blocks = sum(w.numel() * w.element_size()
                 for w in res.state.params.values())
    losses = [h["loss"] for h in res.history]
    gathered = [h.get("gathered_bytes", 0.0) for h in res.history]
    del res
    torch.cuda.empty_cache()
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    total = sum(ms)
    share = {k: v / total for k, v in coll.items()}
    ok = ok and finite and len(losses) == d_steps and max(peaks) < 80
    if rank0:
        line = {"part": "d", "arch": GRANITE, "reduced": False,
                "mesh": f"{world}x1", "batch": [D_ROWS * world, FULL_SEQ],
                "steps": d_steps, "step_ms": ms,
                "steady_ms": statistics.median(ms[1:]),
                "tokens_per_s": D_ROWS * world * FULL_SEQ
                / statistics.median(ms[1:]) * 1e3,
                "losses": losses, "peak_gib_by_card": peaks,
                "param_block_gb_rank0": blocks / 1e9,
                "gathered_gb_a_step": [g / 1e9 for g in gathered],
                "collective_ms": coll, "collective_share": share,
                "schedule_ms": schedule_ms,
                "schedule_share": sum(schedule_ms) / total,
                "wall_s_with_init": wall, "ok": finite}
        report.append(line)
        print(json.dumps(line), flush=True)
    return ok


def _broadcast(obj):
    """``obj`` of rank 0 on every rank."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def main() -> int:
    global LOG
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write rank 0's report to PATH")
    ap.add_argument("--parts", default="abcd")
    ap.add_argument("--d-steps", type=int, default=3)
    ap.add_argument("--log-dir", default="build/mesh_train_logs")
    ap.add_argument("--stack-after", type=float, default=420.0)
    ap.add_argument("--pg-timeout", type=float, default=600.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import faulthandler
    import os
    import traceback
    # granite-3-8b's blocks leave the card little room: let the caching
    # allocator grow segments rather than strand freed ones
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl", timeout=datetime.timedelta(
        seconds=args.pg_timeout))
    world = mesh_lib.init_world("cuda")
    rank = dist.get_rank()
    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    LOG = open(Path(args.log_dir) / f"rank{rank}.log", "w")
    dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch.device import resolve_device
    resolve_device(dev)                  # TF32 off
    rank0 = rank == 0
    report, ok = [], True
    t0 = time.perf_counter()
    parts = {"a": lambda: part_a(dev, rank0, report),
             "b": lambda: part_b(dev, rank0, world, report),
             "c": lambda: part_c(dev, rank0, world, report),
             "d": lambda: part_d(dev, rank0, world, report, args.d_steps)}
    try:
        for name in args.parts:
            log("part", name, "start")
            faulthandler.dump_traceback_later(args.stack_after, repeat=True,
                                              file=LOG)
            ok = parts[name]() and ok
            faulthandler.cancel_dump_traceback_later()
            log("part", name, "end")
            dist.barrier()
    except BaseException:
        # a collective the other ranks never join would block the group's
        # teardown: report and leave without it
        traceback.print_exc()
        log("failed", traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    mesh_lib.destroy_world()
    if rank0:
        card = chip_timing.card()
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "world": world, "ok": ok,
                 "seconds": time.perf_counter() - t0, "parts": report},
                indent=1))
        print(f"mesh_train_check: ok={ok} in "
              f"{time.perf_counter() - t0:.1f} s")
        print(card)
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main())
