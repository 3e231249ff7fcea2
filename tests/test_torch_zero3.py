"""The training state sharded over a mesh (ZeRO-3), held to the port's
replicated mesh step and its one-device step; remat.

One spawn of 4 gloo ranks with torchrun's rank environment
(``tests/test_torch_mesh.py``'s ``_spawn``) runs every mesh arm; this
process runs the same arm functions with ``mesh=None`` for the one-device
results (for the all-to-all, every rank of the 2x2 mesh in this process,
``moe_a2a.apply_moe_a2a_local``):

1. one aligned step of reduced olmo-1b and reduced qwen3-moe under the
   Fig. 7 schedule (BER 1e-3, dynamic) with the state sharded on 4x1 and
   2x2 (qwen3-moe on 2x2 with the mesh set as the ambient one: the
   all-to-all over ``"model"``, its experts gathered over ``"data"``
   only), and the same step with the state replicated (the data-parallel
   step). The sharded init's blocks and the step's faulty blocks are
   bitwise the one-device state's and flips' regions (the flips drawn at
   the blocks' offsets); metrics, gradients and parameters are held at
   ``tests/test_torch_train_kinds.py``'s tolerances to the one-device
   step and to the replicated step;
2. 3 steps of reduced olmo-1b under the schedule, sharded on 2x2 with a
   checkpoint every step, interrupted in step 2 and resumed on 4x1 from a
   copy of the 2x2 checkpoint: it resumes from step 2, and its step-2
   loss is the uninterrupted 2x2 run's within 1e-4; this process resumes
   the same checkpoint on one device, held the same way.

Without ranks: ``RunConfig.remat`` on and off give a bitwise step for
every block kind; the one-process emulation of a 4x1 and a 2x2 sharded
step (``zero3.emulate_step``, the program's step with its ranks in threads
and in-process collectives, what ``chip_smoke.py`` phase 17 runs on the
card) is held to the one-device step, and its in-process combines hold
under more rank threads than cores; and the port's one-device aligned
step of reduced olmo-1b (remat on, the port's default) to the reference's
at the same tolerances.
"""
import dataclasses
import os
import shutil
import textwrap
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import lm, moe_a2a  # noqa: E402
from repro_torch.models.losses import IGNORE  # noqa: E402
from repro_torch.training import loop, steps, zero3  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-5
B1 = 0.9
GRAD_FLOOR = 1e-6
SEQ = 16
BER = 1e-3
ONE4N = ReliabilityPolicy(default=PolicyRule(protect="one4n", n_group=8,
                                             index=2))
QWEN = "qwen3-moe-235b-a22b"


def _run(**kw) -> RunConfig:
    base = dict(steps=1, checkpoint_dir="", learning_rate=1e-3,
                warmup_steps=0, policy=ONE4N, ber=BER, inject="dynamic")
    base.update(kw)
    return RunConfig(**base)


def _cfg(arch: str):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:            # binds: 64 tokens, 40 slots an expert
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return cfg


def _params(cfg) -> dict:
    from repro_torch import convert
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    return convert.flat_from_lm(model)


def _batch(cfg, rows: int = 4) -> dict:
    """MarkovLM rows with labels masked unevenly."""
    b = MarkovLM(cfg.vocab_size, SEQ, rows, seed=3).batch(0)
    labels = np.array(b["labels"])
    labels[0, :9] = IGNORE
    labels[-1, 5:8] = IGNORE
    return {"tokens": b["tokens"], "labels": labels}


def _global(state, mesh):
    """The global leaves of a state on rank 0 (None elsewhere; the state
    itself when it is not sharded)."""
    if state.shards is None:
        return state
    return specs.gather_state(state, mesh, dst=0)


def _recording(faulty: list, mesh):
    """The fault schedule, recording each step's faulty weights (a sharded
    run's gathered on rank 0)."""
    real = loop.make_fault_schedule

    def make(run):
        corrupt = real(run)

        def recorded(params, seed, *layouts):
            out = corrupt(params, seed, *layouts)
            faulty.append(specs.gather_tree(out, layouts[0], mesh, dst=0)
                          if layouts else out)
            return out
        return recorded
    return make


# ------------------------------------------------------------ the arms


def arm_step(mesh, arch: str, shard: bool, ambient: bool = False) -> dict:
    """One aligned step under the schedule through ``run_training``;
    ``shard`` shards the state over ``mesh``; ``ambient`` sets the mesh as
    the ambient one (the MoE's all-to-all)."""
    cfg = _cfg(arch)
    run = _run()
    params = _params(cfg)
    state = steps.init_train_state(None, cfg, run, params=params,
                                   mesh=mesh if shard else None)
    init = _global(state, mesh) if shard else None
    blocks = {p: tuple(w.shape) for p, w in state.params.items()}
    faulty, calls = [], []
    real = moe_a2a.apply_moe_a2a

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    with mock.patch.object(loop, "make_fault_schedule",
                           _recording(faulty, mesh if shard else None)), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", counted), \
            shlib.use_mesh(mesh if ambient else None):
        res = loop.run_training(cfg, run, iter([_batch(cfg)]), state=state,
                                mesh=mesh, device="cpu", shard=shard)
    out = _global(res.state, mesh)
    if out is None:
        return {}
    got = {"metrics": res.history[0], "params": out.params,
           "m": out.opt["m"], "faulty0": faulty[0], "blocks": blocks,
           "a2a_calls": len(calls)}
    if init is not None:
        got["init"] = {"params": init.params, "exps": init.exps,
                       "signs": init.signs}
    return got


class _Interrupt(Exception):
    pass


def _stop_at_2(step, metrics):
    if step == 2:
        raise _Interrupt


def _train_3(mesh, ckpt_dir: str, shard: bool, log_fn=None, fresh=True):
    cfg = _cfg("olmo-1b")
    run = _run(steps=3, checkpoint_dir=ckpt_dir, checkpoint_every=1)
    state = steps.init_train_state(None, cfg, run, params=_params(cfg),
                                   mesh=mesh if shard else None) \
        if fresh else None
    return loop.run_training(
        cfg, run, CheckpointableLoader(MarkovLM(cfg.vocab_size, SEQ, 4,
                                                seed=5)),
        log_fn=log_fn, state=state, mesh=mesh, device="cpu", shard=shard)


def arm_restore(mesh_2x2, mesh_4x1, ckpt_dir: str) -> dict:
    """The 2x2 run uninterrupted, then interrupted in step 2; the 2x2
    checkpoint (step 2) resumed on 4x1 from a copy."""
    whole = _train_3(mesh_2x2, "", True)
    try:
        _train_3(mesh_2x2, ckpt_dir, True, log_fn=_stop_at_2)
    except _Interrupt:
        pass
    shlib.barrier(mesh_2x2)
    copy = ckpt_dir + "_4x1"
    if torch.distributed.get_rank() == 0:
        shutil.copytree(ckpt_dir, copy)
    shlib.barrier(mesh_2x2)
    resumed = _train_3(mesh_4x1, copy, True, fresh=False)
    return {"losses": [h["loss"] for h in whole.history],
            "resumed_from": resumed.info["resumed_from"],
            "resumed_losses": [h["loss"] for h in resumed.history]}


MESH_ARMS = {   # name -> (model axis, arch, sharded, ambient, replicated arm)
    "olmo_4x1": (1, "olmo-1b", True, False, "olmo_4x1_replicated"),
    "olmo_2x2": (2, "olmo-1b", True, False, "olmo_4x1_replicated"),
    "olmo_4x1_replicated": (1, "olmo-1b", False, False, None),
    "moe_4x1": (1, QWEN, True, False, None),
    "moe_a2a_2x2": (2, QWEN, True, True, "moe_a2a_2x2_replicated"),
    "moe_a2a_2x2_replicated": (2, QWEN, False, True, None),
}


def rank_main(ckpt_dir: str) -> dict:
    """Every arm on this rank's meshes (the spawned ranks' entry point)."""
    out = {}
    for name, (model_axis, arch, shard, ambient, _) in MESH_ARMS.items():
        mesh = t_mesh.make_host_mesh(model_axis, "cpu")
        out[name] = arm_step(mesh, arch, shard, ambient)
    out["restore"] = arm_restore(t_mesh.make_host_mesh(2, "cpu"),
                                 t_mesh.make_host_mesh(1, "cpu"), ckpt_dir)
    return out


_WORKER = textwrap.dedent(f'''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {TESTS!r})
    import test_torch_zero3 as T
    out = T.rank_main(sys.argv[1] + ".ckpt")
    if torch.distributed.get_rank() == 0:
        torch.save(out, sys.argv[2])
''')


def one_device(arch: str, ambient: bool) -> dict:
    if not ambient:
        return arm_step(None, arch, False)

    def in_process(weights, cfg, x):     # every rank of the 2x2 mesh here
        return moe_a2a.apply_moe_a2a_local(weights, cfg, x, 2, 2)[:2]
    with mock.patch.object(moe_a2a, "route", lambda *_: True), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", in_process):
        return arm_step(None, arch, False)


# ------------------------------------------------------------ holding


def _fp16_ulps(a, b) -> np.ndarray:
    ha = np.asarray(a, np.float32).astype(np.float16).view(np.int16)
    hb = np.asarray(b, np.float32).astype(np.float16).view(np.int16)
    return np.abs(ha.astype(np.int32) - hb.astype(np.int32))


def _hold_step(got: dict, want: dict, what: str) -> None:
    for k in ("loss", "accuracy", "grad_norm", "aux_loss", "tokens"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=RTOL, err_msg=f"{what} {k}")
    for p, w in want["params"].items():
        g_want = want["m"][p].numpy() / (1 - B1)
        g_got = got["m"][p].numpy() / (1 - B1)
        scale = float(np.abs(g_want).max()) or 1.0
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=f"{what} {p}")
        ulps = _fp16_ulps(w.numpy(), got["params"][p].numpy())[
            np.abs(g_want) > GRAD_FLOOR]
        assert ulps.size == 0 or ulps.max() <= 1, (what, p, int(ulps.max()))


def _bitwise(a: dict, b: dict, what: str) -> None:
    assert list(a) == list(b), what
    for p, t in a.items():
        if t is None:
            assert b[p] is None, (what, p)
            continue
        assert torch.equal(t.contiguous().view(torch.uint8),
                           b[p].contiguous().view(torch.uint8)), (what, p)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_steps_match_replicated_and_one_device(tmp_path):
    from test_torch_mesh import _spawn
    result = _spawn({}, tmp_path, worker=_WORKER)
    want = {arch: {amb: one_device(arch, amb) for amb in (False, True)
                   if amb is False or arch == QWEN}
            for arch in ("olmo-1b", QWEN)}
    ckpt = str(tmp_path / "in.pt") + ".ckpt"
    whole = _train_3(None, "", False)
    got = result()
    # the one-device resume of the 2x2 checkpoint (step 2)
    one = _train_3(None, ckpt, False, fresh=False)

    # 1: the init's blocks and the faulty blocks bitwise, the step held
    for name, (model_axis, arch, shard, ambient, rep) in MESH_ARMS.items():
        w = want[arch][ambient]
        g = got[name]
        _bitwise(g["faulty0"], w["faulty0"], f"{name} flips")
        _hold_step(g, w, name)
        if rep is not None:
            _hold_step(g, got[rep], f"{name} against {rep}")
        assert (g["a2a_calls"] > 0) == ambient, name
        if not shard:
            continue
        c = _cfg(arch)
        ref = steps.init_train_state(None, c, _run(), params=_params(c))
        for f in ("params", "exps", "signs"):
            _bitwise(g["init"][f], getattr(ref, f), f"{name} init {f}")
        # rank 0's blocks: the MLP and the experts split over both axes
        d = 4 // model_axis
        if arch == QWEN:
            e, dm, f_ = ref.params["groups/blk0/moe/moe_win"].shape[1:]
            assert g["blocks"]["groups/blk0/moe/moe_win"][1:] == \
                (e // model_axis, dm // d, f_), name
        else:
            n, dm, ff = ref.params["groups/blk0/mlp/w_gate"].shape
            assert g["blocks"]["groups/blk0/mlp/w_gate"] == \
                (n, dm // d, ff // model_axis), name
    assert got["moe_a2a_2x2"]["metrics"]["aux_loss"] != \
        got["moe_4x1"]["metrics"]["aux_loss"]

    # 2: the resumes
    r = got["restore"]
    np.testing.assert_allclose(r["losses"], [h["loss"] for h in
                                             whole.history], rtol=RTOL)
    assert r["resumed_from"] == 2 and len(r["resumed_losses"]) == 1
    np.testing.assert_allclose(r["resumed_losses"][0], r["losses"][2],
                               rtol=RTOL)
    assert one.info["resumed_from"] == 2
    np.testing.assert_allclose(one.history[0]["loss"], r["losses"][2],
                               rtol=RTOL)


# ------------------------------------------------------- without ranks

REMAT_KINDS = {   # kind -> (arch, config overrides)
    "attn": ("olmo-1b", {}),
    "local": ("olmo-1b", dict(block_pattern=("local",), local_window=8)),
    "moe": (QWEN, {}),
    "rwkv": ("rwkv6-1.6b", {}),
    "rec": ("recurrentgemma-9b", dict(n_layers=4)),
}


@pytest.mark.parametrize("kind", tuple(REMAT_KINDS))
def test_remat_step_is_bitwise(kind):
    """``RunConfig.remat`` recomputes each layer group in the backward:
    metrics, parameters and moments of an aligned step (with the exponent
    regularizer) are bitwise those without it. recurrentgemma at 4 layers
    has a (rec, rec, local) group and a ``rec`` tail layer."""
    arch, ov = REMAT_KINDS[kind]
    cfg = dataclasses.replace(_cfg(arch), **ov)
    params = _params(cfg)
    batch = loop._on_device(_batch(cfg), torch.device("cpu"))
    out = []
    for remat in (True, False):
        run = _run(ber=0.0, remat=remat, exp_reg_coef=0.1)
        state = steps.init_train_state(None, cfg, run, params=params)
        out.append(steps.make_train_step(cfg, run)(state, batch))
    (a, ma), (b, mb) = out
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for f in ("params", "exps", "signs"):
        _bitwise(getattr(a, f), getattr(b, f), f)
    _bitwise(a.opt["m"], b.opt["m"], "m")
    _bitwise(a.opt["v"], b.opt["v"], "v")


@pytest.mark.parametrize("dims", ((4, 1), (2, 2)))
def test_emulated_step_matches_one_device(dims):
    """Two aligned steps of reduced olmo-1b under the schedule, the state
    sharded over a 4x1 or 2x2 mesh whose ranks run in threads of this
    process (``zero3.emulate_step``: the program's step with in-process
    collectives, what ``chip_smoke.py`` phase 17 runs on the card; each
    rank's blocks corrupted at their offsets): the flips bitwise the
    one-device schedule's, each step's metrics within 1e-4, the gathered
    bytes those of the split leaves (the forward's) and the state after the
    first step at the tolerances above."""
    cfg = _cfg("olmo-1b")
    run = _run(steps=2)
    assert run.remat
    corrupt = loop.make_fault_schedule(run)
    params = _params(cfg)
    meshes = shlib.thread_ranks(("data", "model"), dims)
    states = [steps.init_train_state(None, cfg, run, params=params, mesh=m)
              for m in meshes]
    lays = states[0].shards.params
    gathered = sum(w.numel() * 4 for p, w in params.items()
                   if not lays[p].whole)
    one = steps.init_train_state(None, cfg, run, params=params)
    step = steps.make_train_step(cfg, run)
    for i in range(2):
        batch = loop._on_device(_batch(cfg) if i == 0 else MarkovLM(
            cfg.vocab_size, SEQ, 4, seed=9).batch(0), torch.device("cpu"))
        seed = loop.step_seed(run, i)
        one = dataclasses.replace(one, params=corrupt(one.params, seed))
        states = [dataclasses.replace(s, params=corrupt(
            s.params, seed, s.shards.params)) for s in states]
        if i == 0:
            faulty = specs.gather_local(states, [s.shards for s in states])
            _bitwise(faulty.params, one.params, "flips")
        one, want = step(one, batch)
        states, got = zero3.emulate_step(cfg, run, states, meshes, batch)
        assert float(got["gathered_bytes"]) == gathered
        for k in ("loss", "accuracy", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, err_msg=k)
        if i == 0:      # after one step: the step's tolerances
            whole = specs.gather_local(states, [s.shards for s in states])
            _hold_step({"metrics": {k: float(got.get(k, want[k]))
                                    for k in want},
                        "params": whole.params, "m": whole.opt["m"]},
                       {"metrics": {k: float(v) for k, v in want.items()},
                        "params": one.params, "m": one.opt["m"]}, "step 0")


def test_thread_mesh_collectives_under_stress():
    """The in-process combines of ``sharding.ThreadMesh`` with more rank
    threads than cores and a short switch interval: over 40 rounds every
    rank's in-place all-reduce over the mesh, sum over "data",
    reduce-scatter over "model" and all-gather over "data" equal the
    rank-order results computed here (a lost or stale slot breaks them)."""
    import sys
    import threading
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    d = cores // 2 + 1
    meshes = shlib.thread_ranks(("data", "model"), (d, 2), timeout=60.0)
    n, rounds = len(meshes), 40

    def value(r, i):
        return torch.arange(4, dtype=torch.float32) * (r + 1) + 1000 * i
    failures = []

    def rank(m):
        try:
            for i in range(rounds):
                t = value(m.rank, i)
                whole = shlib.all_reduce_mesh(t.clone(), m)
                want = value(0, i).clone()
                for r in range(1, n):
                    want = want + value(r, i)
                col = [m.at("data", k).rank for k in range(d)]
                row = [m.at("model", k).rank for k in range(2)]
                data_sum = value(col[0], i).clone()
                for r in col[1:]:
                    data_sum = data_sum + value(r, i)
                model_sum = value(row[0], i) + value(row[1], i)
                got = (whole, shlib.all_reduce_sum(t, "data", m),
                       shlib.reduce_scatter(t, "model", m),
                       shlib.all_gather_cat(t, "data", m))
                want = (want, data_sum,
                        model_sum.chunk(2)[shlib.axis_index("model", m)],
                        torch.cat([value(r, i) for r in col]))
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        failures.append((m.rank, i))
        except Exception as e:         # reported by the assertion below
            failures.append((m.rank, repr(e)))
            m.group.abort()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=rank, args=(m,)) for m in meshes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:4]


def test_one_device_step_matches_reference():
    """The port's one-device aligned step (remat on, the port's default;
    the data-parallel and sharded steps above are held to it) against the
    reference's on reduced olmo-1b, from one aligned state and the masked
    batch of the mesh arms."""
    jax = pytest.importorskip("jax")
    from test_torch_kinds import O0, reference
    from test_torch_train_kinds import _j_state, _np_tree, _runs
    from repro.training import steps as j_steps
    from repro_torch import convert
    from repro_torch.core import tree
    r = reference("olmo-1b")
    jrun, trun = _runs()
    assert trun.remat
    tstate = steps.init_train_state(None, r.cfg, trun,
                                    params=convert.flat_from_jax(r.jp))
    jstate = _j_state(r, tstate)
    batch = _batch(r.cfg)
    jnew, jm = jax.jit(j_steps.make_train_step(r.jcfg, jrun),
                       compiler_options=O0)(jstate, batch)
    tnew, tm = steps.make_train_step(r.cfg, trun)(
        tstate, loop._on_device(batch, torch.device("cpu")))
    jmets = {k: float(jm[k]) for k in ("loss", "accuracy", "grad_norm",
                                       "aux_loss", "tokens")
             if k in jm}
    want = {"metrics": {k: jmets.get(k, float(tm[k])) for k in
                        ("loss", "accuracy", "grad_norm", "aux_loss",
                         "tokens")},
            "params": {p: torch.from_numpy(np.array(v)) for p, v in
                       tree.flatten(_np_tree(jnew.params)).items()},
            "m": {p: torch.from_numpy(np.array(v)) for p, v in
                  tree.flatten(_np_tree(jnew.opt["m"])).items()}}
    _hold_step({"metrics": {k: float(v) for k, v in tm.items()},
                "params": tnew.params, "m": tnew.opt["m"]}, want,
               "one device")
