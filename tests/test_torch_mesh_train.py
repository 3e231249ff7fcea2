"""Data-parallel training and the co-design loop on a mesh, held to the
port's one-device results (which ``tests/test_torch_train_kinds.py``,
``tests/test_torch_codesign.py`` and ``tests/test_torch_kinds.py`` hold to
the JAX reference).

Every arm is a plain function of ``mesh`` in this module: the ranks run it
on their mesh, this process runs it with ``mesh=None`` (the all-to-all's
ranks all run here, ``moe_a2a.apply_moe_a2a_local``) for the one-device
result. One
spawn of 4 gloo ranks with torchrun's environment
(``tests/test_torch_mesh.py``'s ``_spawn``) runs every arm:

1. one aligned step of reduced olmo-1b on 4x1 and 2x2 over a batch whose
   labels are IGNORE-masked unevenly over the rows, and on 4x1 over a
   3-row batch that the data axis does not divide (replicated);
2. one aligned step of reduced qwen3-moe at a binding capacity: the dense
   dispatch under data parallelism on 4x1 (capacity, drops and aux of the
   global batch), and the all-to-all over "model" on 2x2 with the mesh set
   as the ambient one, against the one-device emulation of that mesh;
3. the Fig. 7 schedule (BER 1e-3, dynamic) over 3 steps on 2x2: every
   rank's faulty weights equal each other's every step, and step 0's
   equal the one-device draw bitwise;
4. the same run interrupted after 2 steps (rank 0 writes the checkpoints)
   and resumed to 3 on every rank: the final state equals the
   uninterrupted run's bitwise;
5. the ``Finetuner`` (2 reshape and 2 aligned steps) on 4x1;
6. ``PolicySearch.select`` and ``.search`` with a 4-rank trial mesh
   (``SweepEngine(plan, mesh=make_trial_mesh())``): the same choices,
   accuracies and trace.

Tolerances are ``tests/test_torch_train_kinds.py``'s: metrics within 1e-4
relative; gradients (AdamW's first moment after one step is 0.1 g) within
allclose(1e-4, 1e-5 of the leaf's largest); stepped parameters within one
fp16 ulp where the gradient exceeds 1e-6. Over several steps the losses
are held within 1e-4 relative. Every rank's state is checked bitwise equal
to rank 0's after each arm. A 1x1 mesh in this process (a world-size-1
group) gives the unmeshed results bitwise.
"""
import dataclasses
import os
import textwrap
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import lm, moe_a2a  # noqa: E402
from repro_torch.models.losses import IGNORE  # noqa: E402
from repro_torch.training import codesign, loop, steps  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-5
B1 = 0.9
GRAD_FLOOR = 1e-6
SEQ = 16
ONE4N = ReliabilityPolicy(default=PolicyRule(protect="one4n", n_group=8,
                                             index=2))
SEARCH_BER = 3e-4


def _run(**kw) -> RunConfig:
    base = dict(steps=1, checkpoint_dir="", learning_rate=1e-3,
                warmup_steps=0, policy=ONE4N)
    base.update(kw)
    return RunConfig(**base)


def _cfg(arch: str):
    cfg = get_config(arch).reduced()
    if cfg.n_experts:            # binds: 64 tokens, 40 slots an expert
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return cfg


def _params(cfg, seed: int = 0) -> dict:
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(seed),
                  device="cpu")
    return convert.flat_from_lm(model)


def _batch(cfg, rows: int, seed: int = 3) -> dict:
    """MarkovLM rows with labels masked unevenly: 9 of row 0's, 3 of the
    last row's, none of the others'."""
    b = MarkovLM(cfg.vocab_size, SEQ, rows, seed=seed).batch(0)
    labels = np.array(b["labels"])
    labels[0, :9] = IGNORE
    labels[-1, 5:8] = IGNORE
    return {"tokens": b["tokens"], "labels": labels}


def _same(mesh, tensors) -> bool:
    return mesh is None or shlib.same_on_every_rank(list(tensors), mesh)


# ------------------------------------------------------------ the arms


def arm_step(mesh, arch: str, rows: int, ambient: bool = False) -> dict:
    """One aligned step through ``run_training``; ``ambient`` sets the
    mesh as the ambient one (the MoE's all-to-all)."""
    cfg = _cfg(arch)
    run = _run()
    state = steps.init_train_state(None, cfg, run, params=_params(cfg))
    calls = []
    real = moe_a2a.apply_moe_a2a

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    with mock.patch.object(moe_a2a, "apply_moe_a2a", counted), \
            shlib.use_mesh(mesh if ambient else None):
        res = loop.run_training(cfg, run, iter([_batch(cfg, rows)]),
                                state=state, mesh=mesh, device="cpu")
    return {"metrics": res.history[0], "params": res.state.params,
            "m": res.state.opt["m"], "a2a_calls": len(calls),
            "same": _same(mesh, res.state.params.values())}


def _recording_schedule(faulty: list):
    real = loop.make_fault_schedule

    def make(run):
        corrupt = real(run)

        def recorded(params, seed):
            out = corrupt(params, seed)
            faulty.append(out)
            return out
        return recorded
    return make


class _Interrupt(Exception):
    pass


def _stop_at_2(step, metrics):
    if step == 2:
        raise _Interrupt


def arm_schedule(mesh, ckpt_dir=None) -> dict:
    """3 steps of reduced olmo-1b under the Fig. 7 schedule at BER 1e-3,
    uninterrupted; with ``ckpt_dir`` also the same run checkpointed there
    every step, interrupted in step 2 and resumed on every rank."""
    cfg = _cfg("olmo-1b")
    params = _params(cfg)

    def train(faulty, fresh=True, log_fn=None, **kw):
        run = _run(steps=3, ber=1e-3, inject="dynamic", **kw)
        state = steps.init_train_state(None, cfg, run, params=params) \
            if fresh else None
        with mock.patch.object(loop, "make_fault_schedule",
                               _recording_schedule(faulty)):
            return loop.run_training(
                cfg, run, CheckpointableLoader(MarkovLM(cfg.vocab_size, SEQ,
                                                        4, seed=5)),
                log_fn=log_fn, state=state, mesh=mesh, device="cpu")
    faulty = []
    whole = train(faulty)
    out = {"losses": [h["loss"] for h in whole.history],
           "faulty0": faulty[0], "params": whole.state.params,
           "faulty_same": all(_same(mesh, f.values()) for f in faulty)}
    if ckpt_dir is not None:
        kw = dict(checkpoint_dir=ckpt_dir, checkpoint_every=1)
        try:
            train([], log_fn=_stop_at_2, **kw)
        except _Interrupt:
            pass
        if mesh is not None:    # rank 0's writer has closed: step 2 is in
            shlib.barrier(mesh)
        resumed = train([], fresh=False, **kw)
        out["resumed_from"] = resumed.info["resumed_from"]
        out["resumed_equal"] = all(
            torch.equal(w, resumed.state.params[p])
            for p, w in whole.state.params.items())
    return out


def arm_finetune(mesh) -> dict:
    cfg = _cfg("olmo-1b")
    data = MarkovLM(cfg.vocab_size, SEQ, 4, seed=0)
    res = codesign.Finetuner(cfg, ReliabilityPolicy(), ber=1e-3,
                             reshape_steps=2, aligned_steps=2, seed=0,
                             mesh=mesh, device="cpu").run(iter(data))
    return {"losses": [h["loss"] for h in res.info["reshape"]["history"]
                       + res.history],
            "params": res.state.params,
            "same": _same(mesh, res.state.params.values())}


def arm_search(trial_mesh) -> dict:
    """``select`` over the smoke's two arms and ``search`` over two groups
    on reduced olmo-1b, 4 trials an evaluation (one a rank)."""
    cfg = _cfg("olmo-1b")
    flat = _params(cfg, seed=5)
    toks = torch.as_tensor(MarkovLM(cfg.vocab_size, SEQ, 2, seed=0)
                           .batch(0)["tokens"], dtype=torch.int64)
    with torch.no_grad():
        labels = lm.forward(lm.shell(cfg), flat, toks).argmax(-1)
    acc = codesign.lm_accuracy_eval(cfg, [{"tokens": toks.numpy(),
                                           "labels": labels.numpy()}])
    slo = codesign.AccuracySLO(ber=SEARCH_BER, max_drop=0.78)

    def searcher(space=None):
        engine = None if trial_mesh is None else sweep.SweepEngine(
            sweep.SweepPlan(bers=(SEARCH_BER,), n_trials=4), device="cpu",
            mesh=trial_mesh)
        return codesign.PolicySearch(flat, acc, slo, space, n_trials=4,
                                     seeds=11, engine=engine, device="cpu")
    sel = searcher().select(codesign.smoke_candidates())
    space = codesign.SearchSpace(groups=(("embed", "embed"),
                                         ("unembed", "unembed")),
                                 protects=("none", "one4n"),
                                 fields=("exponent_sign",))
    found = searcher(space).search()
    return {"select": (sel.name, sel.accuracy, sel.stored_bits,
                       sel.slo_met),
            "search": (found.trace, found.assignment, found.slo_met,
                       found.accuracy)}


MESH_ARMS = {   # name -> (model axis, arm, args)
    "olmo_4x1": (1, arm_step, ("olmo-1b", 4)),
    "olmo_2x2": (2, arm_step, ("olmo-1b", 4)),
    "olmo_4x1_indivisible": (1, arm_step, ("olmo-1b", 3)),
    "moe_dense_4x1": (1, arm_step, ("qwen3-moe-235b-a22b", 4)),
    "moe_a2a_2x2": (2, arm_step, ("qwen3-moe-235b-a22b", 4, True)),
    "schedule_2x2": (2, arm_schedule, ()),
    "finetune_4x1": (1, arm_finetune, ()),
}


def rank_main(ckpt_dir: str) -> dict:
    """Every arm on this rank's meshes (the spawned ranks' entry point)."""
    out = {}
    for name, (model_axis, arm, args) in MESH_ARMS.items():
        mesh = t_mesh.make_host_mesh(model_axis, "cpu")
        if arm is arm_schedule:
            args = (ckpt_dir,)
        out[name] = arm(mesh, *args)
    out["search"] = arm_search(t_mesh.make_trial_mesh(0, "cpu"))
    t_mesh.destroy_world()
    return out


_WORKER = textwrap.dedent(f'''
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {TESTS!r})
    import test_torch_mesh_train as T
    out = T.rank_main(sys.argv[1] + ".ckpt")
    if int(__import__("os").environ["RANK"]) == 0:
        torch.save(out, sys.argv[2])
''')


def one_device(name: str) -> dict:
    model_axis, arm, args = MESH_ARMS[name]
    if name != "moe_a2a_2x2":
        return arm(None, *args)

    def in_process(weights, cfg, x):     # every rank of the 2x2 mesh here
        return moe_a2a.apply_moe_a2a_local(weights, cfg, x, 2, 2)[:2]
    with mock.patch.object(moe_a2a, "route", lambda *_: True), \
            mock.patch.object(moe_a2a, "apply_moe_a2a", in_process):
        return arm(None, *args)


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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_four_ranks_match_one_device(tmp_path):
    from test_torch_mesh import _spawn
    result = _spawn({}, tmp_path, worker=_WORKER)
    want = {name: one_device(name) for name in MESH_ARMS}
    want["search"] = arm_search(None)
    got = result()

    # 1-2: one step each, every rank's state equal to rank 0's
    for name in ("olmo_4x1", "olmo_2x2", "olmo_4x1_indivisible",
                 "moe_dense_4x1", "moe_a2a_2x2"):
        assert got[name]["same"], name
        _hold_step(got[name], want[name], name)
    # the batch's masks differ between rows: 3-row and 4-row counts
    assert got["olmo_4x1"]["metrics"]["tokens"] == 4 * SEQ - 12
    assert got["olmo_4x1_indivisible"]["metrics"]["tokens"] == 3 * SEQ - 12
    assert got["moe_a2a_2x2"]["a2a_calls"] > 0
    assert got["moe_dense_4x1"]["a2a_calls"] == 0
    # the all-to-all's aux (local statistics) is not the dense dispatch's
    assert got["moe_a2a_2x2"]["metrics"]["aux_loss"] != \
        want["moe_dense_4x1"]["metrics"]["aux_loss"]

    # 3-4: the schedule and the resume
    s, w = got["schedule_2x2"], want["schedule_2x2"]
    assert s["faulty_same"]
    for p, t in w["faulty0"].items():
        assert torch.equal(t.view(torch.int32), s["faulty0"][p].view(
            torch.int32)), p
    np.testing.assert_allclose(s["losses"], w["losses"], rtol=RTOL)
    assert s["resumed_from"] == 2 and s["resumed_equal"]

    # 5: the Finetuner
    f, w = got["finetune_4x1"], want["finetune_4x1"]
    assert f["same"] and len(f["losses"]) == 4
    np.testing.assert_allclose(f["losses"], w["losses"], rtol=RTOL)

    # 6: the search on a trial mesh
    assert got["search"] == want["search"]


def test_dense_dispatch_binds_on_the_global_batch():
    """The one-device reference of the MoE arms drops tokens, so a rank
    that dispatched its own rows alone (other capacity, other drops) would
    not match it."""
    from repro_torch.models import moe as t_moe
    cfg = _cfg("qwen3-moe-235b-a22b")
    params = _params(cfg)
    x = torch.as_tensor(_batch(cfg, 4)["tokens"])
    block = lm.shell(cfg)
    h = {}

    def grab(mod, args, out):
        h.setdefault("x", args[0])
    handle = block.blocks[0].moe.register_forward_hook(grab)
    try:
        with torch.no_grad():
            lm.forward(block, params, x)
    finally:
        handle.remove()
    weights = tuple(params[f"groups/blk0/moe/{n}"][0] for n in
                    ("router", "moe_wgate", "moe_win", "moe_wout"))
    xt = h["x"].reshape(-1, cfg.d_model)
    _, _, keep = t_moe.dense_dispatch(weights, cfg, xt)
    assert (~keep).any()                  # the global batch drops
    local = [t_moe.dense_dispatch(weights, cfg, xt[i * SEQ:(i + 1) * SEQ])[2]
             for i in range(4)]
    assert not torch.equal(torch.cat(local), keep)


@pytest.fixture(scope="module")
def one_rank_mesh():
    mesh = t_mesh.make_host_mesh(1, "cpu")
    yield mesh
    t_mesh.destroy_world()


def test_one_rank_mesh_is_bitwise_unmeshed(one_rank_mesh):
    got = arm_step(one_rank_mesh, "olmo-1b", 4)
    want = arm_step(None, "olmo-1b", 4)
    assert got["metrics"] == want["metrics"] or all(
        got["metrics"][k] == want["metrics"][k]
        for k in want["metrics"] if k != "step_time")
    for p, w in want["params"].items():
        assert torch.equal(w, got["params"][p]), p
    f1, f0 = arm_finetune(one_rank_mesh), arm_finetune(None)
    assert f1["losses"] == f0["losses"]
    for p, w in f0["params"].items():
        assert torch.equal(w, f1["params"][p]), p


def test_finetuner_auto_mesh_stays_on_one_device(monkeypatch):
    """``mesh='auto'`` without torchrun's environment (or with a world of
    one) builds no mesh and starts no process group."""
    cfg = _cfg("olmo-1b")
    started = torch.distributed.is_initialized()
    for env in ({}, {"WORLD_SIZE": "1"}):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ft = codesign.Finetuner(cfg, ReliabilityPolicy(), mesh="auto",
                                device="cpu")
        assert ft._mesh() is None
    assert torch.distributed.is_initialized() == started
