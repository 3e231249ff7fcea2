"""The port's fault-tolerance substrate against the JAX reference:
checkpoints and auto-resume, the elastic coordinator, the straggler
watchdog, int8 error-feedback gradient compression and the checkpointable
data loader.

The single-process tests of ``tests/test_fault_tolerance.py`` are mirrored
on the port. ``test_dynamic_injection_protected_vs_not`` is mirrored over
seeds: its claim (One4N finite over 8 steps at BER 2e-3, no protection
non-finite or worse) holds or fails by the fault stream, which is the
counter PRNG's on the port and ``jax.random``'s in the reference.
``tools/fig7_seed_study.py`` runs both over run seeds 0-15: One4N
non-finite in 3 of 16 on each side, no protection in 16 of 16, the claim
on 13 of 16 on each. Beside them, held against the reference: ``quantize_int8`` and
``compress_decompress`` bitwise on the same arrays (both eager), the
checkpointable loader's batches after a resume, and one compressed training
step within ``tests/test_torch_train.py``'s tolerances (losses, accuracies
and gradient norms within 1e-4 relative, parameters within one fp16 ulp).
Within the port, bitwise: a run interrupted after its step-2 checkpoint and
resumed equals an uninterrupted one (parameters, moments, step count,
compression residuals and losses), with and without compression.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.deployment import PolicyRule as JRule  # noqa: E402
from repro.core.deployment import ReliabilityPolicy as JPolicy  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.distributed import compression as j_comp  # noqa: E402
from repro.training import loop as j_loop  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import faultmodels as t_fm  # noqa: E402
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy  # noqa: E402
from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compress_decompress, dequantize_int8, quantize_int8)
from repro_torch.distributed.elastic import (  # noqa: E402
    ElasticCoordinator, StragglerWatchdog)
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.training import loop as t_loop  # noqa: E402

METRIC_RTOL = 1e-4      # tests/test_torch_train.py's


def _align_policy():
    return ReliabilityPolicy(default=PolicyRule(protect="one4n", n_group=8,
                                                index=2))


def _tiny_run(tmp_path, steps=6, every=3, align=False, **kw):
    cfg = get_config("olmo-1b").reduced()
    if align:
        kw["policy"] = _align_policy()
    run = RunConfig(steps=steps, checkpoint_every=every,
                    checkpoint_dir=str(tmp_path), **kw)
    return cfg, run, MarkovLM(cfg.vocab_size, 32, 2, seed=0)


def _train(cfg, run, batches, **kw):
    return t_loop.run_training(cfg, run, batches, device="cpu", **kw)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_exact(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)},
             "n": None, "s": torch.tensor(3)}
    ckpt.save(state, 7, str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, step = ckpt.restore(state, str(tmp_path))
    assert step == 7
    assert torch.equal(restored["a"], state["a"])
    assert (restored["b"]["c"] == 1).all()
    assert restored["n"] is None
    assert torch.equal(restored["s"], state["s"])


def test_checkpoint_atomic_overwrite(tmp_path):
    state = {"a": torch.zeros(3)}
    ckpt.save(state, 1, str(tmp_path))
    ckpt.save({"a": torch.ones(3)}, 2, str(tmp_path))
    restored, step = ckpt.restore(state, str(tmp_path))
    assert step == 2 and (restored["a"] == 1).all()
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_checkpointer_and_gc(tmp_path):
    cp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(1, 5):
        cp.save_async({"x": torch.full((4,), float(s))}, s)
    cp.wait()
    cp.close()
    steps_on_disk = sorted(d for d in os.listdir(tmp_path)
                           if d.startswith("step_"))
    assert len(steps_on_disk) == 2
    restored, step = ckpt.restore({"x": torch.zeros(4)}, str(tmp_path))
    assert step == 4 and (restored["x"] == 4).all()


def test_async_checkpointer_copies_before_returning(tmp_path):
    """The writer saves the values of the save call, not later ones."""
    x = torch.zeros(4)
    cp = ckpt.AsyncCheckpointer(str(tmp_path))
    cp.save_async({"x": x}, 1)
    x.add_(5.0)
    cp.close()
    assert (ckpt.restore(None, str(tmp_path))[0]["x"] == 0).all()


def test_checkpoint_stores_and_runtime_without_pickles(tmp_path):
    """A serving params dict (packed stores of every protection, a row
    cache, the dynamic runtime with its fault process) round-trips bit for
    bit; the tensor file loads with ``weights_only=True`` and the manifest
    holds the stores' configs as plain fields."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(24, 40, generator=g) * 0.1
    params = {p: t_cim.pack(w, t_cim.CIMConfig(protect=p))
              for p in ("one4n", "per_weight", "none")}
    params["one4n"] = t_cim.build_row_cache(params["one4n"])
    params["plain"] = w
    params["_cim"] = {"seeds": {"man": 1, "meta": 2, "cw": 3},
                      "thr_man": 99, "thr_meta": 7,
                      "model": t_fm.parse_fault_model("burst:rate=0.5")}
    ckpt.save(params, 0, str(tmp_path))
    got, _ = ckpt.restore(params, str(tmp_path), device="cpu")
    for p in ("one4n", "per_weight", "none"):
        a, b = params[p], got[p]
        assert (a.shape, a.cfg) == (b.shape, b.cfg)
        for name in ("man", "sign", "exp", "codewords", "cache"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), (p, name)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), (p, name)
    assert torch.equal(got["plain"], w)
    assert got["_cim"] == params["_cim"]
    step = os.path.join(tmp_path, "step_00000000")
    torch.load(os.path.join(step, "tensors.pt"), weights_only=True)
    with open(os.path.join(step, "manifest.json")) as f:
        manifest = f.read()
    assert '"protect": "per_weight"' in manifest
    assert ckpt.step_bytes(str(tmp_path)) > 0
    with pytest.raises(ValueError, match="differ"):
        ckpt.restore({"plain": w}, str(tmp_path))


def test_training_auto_resume(tmp_path):
    cfg, run, data = _tiny_run(tmp_path, steps=4, every=2)
    state1, hist1, info1 = _train(cfg, run, iter(data))
    assert info1["resumed_from"] == 0
    run2 = RunConfig(**{**run.__dict__, "steps": 6})
    state2, hist2, info2 = _train(cfg, run2, iter(data))
    assert info2["resumed_from"] == 4
    assert len(hist2) == 2
    assert int(state2.opt["step"]) == 6


def test_resume_preserves_frozen_exponents(tmp_path):
    cfg, run, data = _tiny_run(tmp_path, steps=2, every=2, align=True)
    state1, _, _ = _train(cfg, run, iter(data))
    run2 = RunConfig(**{**run.__dict__, "steps": 4})
    state2, _, info = _train(cfg, run2, iter(data))
    assert info["resumed_from"] == 2
    assert torch.equal(state1.exps["unembed"], state2.exps["unembed"])


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("compress", [False, True])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, compress):
    """4 aligned steps uninterrupted, against the same run interrupted at
    step 2 (after its step-2 checkpoint) and resumed through the
    checkpointable loader: every saved leaf and every loss bitwise."""
    cfg, run, _ = _tiny_run(tmp_path / "ck", steps=4, every=2, align=True,
                            warmup_steps=1, learning_rate=1e-3,
                            grad_compression=compress)

    def loader():
        return CheckpointableLoader(MarkovLM(cfg.vocab_size, 32, 2, seed=0))

    whole = _train(cfg, RunConfig(**{**run.__dict__, "checkpoint_dir": ""}),
                   loader())

    def stop(step, metrics):
        if step == 2:
            raise _Interrupt
    with pytest.raises(_Interrupt):
        _train(cfg, run, loader(), log_fn=stop)
    assert ckpt.latest_step(run.checkpoint_dir) == 2
    resumed = _train(cfg, run, loader())
    assert resumed.info["resumed_from"] == 2
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[2:]]
    a, b = whole.state, resumed.state
    assert int(a.opt["step"]) == int(b.opt["step"]) == 4
    for tree in ("params", "exps", "signs", "ef_error"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        assert (ta is None) == (tb is None) == (tree == "ef_error"
                                                and not compress)
        for p in ta or {}:
            assert (ta[p] is None and tb[p] is None) or \
                torch.equal(ta[p], tb[p]), (tree, p)
    for p in a.params:
        assert torch.equal(a.opt["m"][p], b.opt["m"][p])
        assert torch.equal(a.opt["v"][p], b.opt["v"][p])
    saved, _ = ckpt.restore(None, run.checkpoint_dir)
    assert saved["data"] == {"cursor": 4}


def test_resume_refuses_a_compression_mismatch(tmp_path):
    cfg, run, data = _tiny_run(tmp_path, steps=1, every=1)
    _train(cfg, run, iter(data))
    run2 = RunConfig(**{**run.__dict__, "steps": 2, "grad_compression": True})
    with pytest.raises(ValueError, match="without gradient compression"):
        _train(cfg, run2, iter(data))


def test_launcher_resumes_on_cpu(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--seq", "16", "--batch", "2",
            "--rel-mode", "align", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    first = t_train.main(argv + ["--steps", "2"])
    again = t_train.main(argv + ["--steps", "3", "--log-jsonl",
                                 str(tmp_path / "log.jsonl")])
    assert first.info["resumed_from"] == 0 and len(first.history) == 2
    assert again.info["resumed_from"] == 2 and len(again.history) == 1
    assert "resumed_from=2" in capsys.readouterr().out
    with open(tmp_path / "log.jsonl") as f:
        assert json.loads(f.readline())["step"] == 2


# ---------------------------------------------------------------- elastic

def test_elastic_failure_detection_and_reshape():
    t = [0.0]
    co = ElasticCoordinator([f"h{i}" for i in range(8)], model_axis=16,
                            heartbeat_timeout=10.0, clock=lambda: t[0])
    t[0] = 5.0
    for h in co.hosts:
        co.heartbeat(h)
    t[0] = 12.0
    assert co.check() == []
    t[0] = 20.0
    for h in co.hosts:
        if h not in ("h3", "h5"):
            co.heartbeat(h)
    t[0] = 29.0
    failed = co.check()
    assert sorted(failed) == ["h3", "h5"]
    assert len(co.healthy_hosts) == 6
    gen, dp = co.reconfigure(devices_per_host=32)
    assert gen == 1 and dp == 8


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=3.0)
    assert not wd.observe(1.0)
    for _ in range(5):
        assert not wd.observe(1.05)
    assert wd.observe(5.0)
    assert wd.flagged == 1
    assert wd.ewma < 1.2


def test_straggler_flag_in_training(tmp_path):
    """A step slowed past ``factor`` x every earlier observed step is
    flagged. The reference sleeps a fixed 0.4 s; a reduced CPU step takes
    ~20 ms alone but seconds beside other test workers, so the sleep here
    is 4.5x the slowest step the watchdog has seen (its EWMA is a convex
    combination of those), which flags the step on any machine."""
    cfg, run, data = _tiny_run(tmp_path, steps=6, every=100,
                               straggler_factor=4.0)
    run = RunConfig(**{**run.__dict__, "checkpoint_dir": ""})
    seen = []

    def log(step, metrics):
        seen.append(metrics["step_time"])
    _, _, info = _train(cfg, run, iter(data), log_fn=log,
                        sleep_injector=lambda s: 4.5 * max(seen[1:])
                        if s == 4 else 0.0)
    assert info["stragglers_flagged"] >= 1


# ---------------------------------------------------------------- compression

def test_int8_quantization_error_bound():
    x = torch.randn(256, generator=torch.Generator().manual_seed(0)) * 3
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_reduces_bias():
    """With EF, the accumulated compressed signal tracks the true sum."""
    g = torch.randn(64, 64, generator=torch.Generator().manual_seed(1)) * 0.01
    ef = {"w": torch.zeros(64, 64)}
    total_true = torch.zeros(64, 64)
    total_sent = torch.zeros(64, 64)
    for i in range(20):
        gi = {"w": g * (1 + 0.1 * i)}
        sent, ef = compress_decompress(gi, ef)
        total_true += gi["w"]
        total_sent += sent["w"]
    resid = float((total_true - total_sent - ef["w"]).abs().max())
    assert resid < 1e-4


def test_compression_matches_reference_bitwise():
    """``quantize_int8`` (codes and scale), ``dequantize_int8`` and
    ``compress_decompress`` (grads and residuals) against the reference,
    eager on both sides, on arrays with ties at half a quantum, an all-zero
    leaf and float16 gradients."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(257).astype(np.float32) * 3,
              np.zeros((4, 4), np.float32),
              (np.arange(-254, 255, dtype=np.float32) / 2.0),
              rng.standard_normal((16, 33)).astype(np.float32) * 1e-30]
    for a in arrays:
        jq, js = j_comp.quantize_int8(jnp.asarray(a))
        tq, ts = quantize_int8(torch.from_numpy(a))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).view(np.uint32) == ts.numpy().view(np.uint32)
        jd = np.asarray(j_comp.dequantize_int8(jq, js))
        assert np.array_equal(jd.view(np.uint32),
                              dequantize_int8(tq, ts).numpy().view(np.uint32))
    grads = {"a": rng.standard_normal((8, 12)).astype(np.float32),
             "b": rng.standard_normal(20).astype(np.float16),
             "c": np.zeros(3, np.float32)}
    ef = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
          for k, v in grads.items()}
    jg, je = grads, ef
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    te = {k: torch.from_numpy(v) for k, v in ef.items()}
    for _ in range(3):       # residuals carried across steps
        jg, je = j_comp.compress_decompress(
            {k: jnp.asarray(v) for k, v in grads.items()}, je)
        tg, te = compress_decompress(
            {k: torch.from_numpy(v) for k, v in grads.items()}, te)
        for k in grads:
            assert np.asarray(jg[k]).dtype == tg[k].numpy().dtype
            assert np.array_equal(np.asarray(jg[k]), tg[k].numpy()), k
            assert np.array_equal(np.asarray(je[k]).view(np.uint32),
                                  te[k].numpy().view(np.uint32)), k


def test_training_with_compression_converges(tmp_path):
    cfg, run, data = _tiny_run(tmp_path, steps=8, every=100)
    run = RunConfig(**{**run.__dict__, "checkpoint_dir": "",
                       "grad_compression": True})
    _, hist, _ = _train(cfg, run, iter(data))
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.1
    assert np.isfinite([h["loss"] for h in hist]).all()


# ---------------------------------------------------------------- dynamic faults

FIG7_SEEDS = range(8)


def test_dynamic_injection_protected_vs_not():
    """The reference's Fig. 7 claim at smoke scale, over run seeds 0-7 (one
    seed is one fault stream): at BER 2e-3 under the dynamic schedule, One4N
    keeps the loss finite in at least half the runs and its median last
    loss below the unprotected runs', which are non-finite in at least
    three quarters; the reference's per-run assertion (One4N finite, no
    protection non-finite or 0.5 above) holds in at least half. The
    reference meets each bound over seeds 0-15 (13 of 16 finite, 16 of 16
    non-finite, the claim on 13), as the port does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        last = {}
        for protect in ("one4n", "none"):
            cfg, run, data = _tiny_run("", steps=8, every=100)
            last[protect] = []
            for seed in FIG7_SEEDS:
                run = RunConfig(**{**run.__dict__, "seed": seed,
                                   "checkpoint_dir": "", "ber": 2e-3,
                                   "inject": "dynamic",
                                   "policy": ReliabilityPolicy(
                                       default=PolicyRule(protect=protect))})
                losses = np.asarray([h["loss"] for h in _train(
                    cfg, run, iter(data)).history])
                last[protect].append(losses[-1] if np.isfinite(losses).all()
                                     else np.inf)
    finally:
        torch.set_num_threads(n)
    good, bad = np.asarray(last["one4n"]), np.asarray(last["none"])
    k = len(FIG7_SEEDS)
    assert np.isfinite(good).sum() >= k / 2, good
    assert (~np.isfinite(bad)).sum() >= 3 * k / 4, bad
    assert np.median(good) < np.median(bad), (good, bad)
    claim = np.isfinite(good) & (~np.isfinite(bad) | (bad > good + 0.5))
    assert claim.sum() >= k / 2, (good, bad)


def _fp16_ulps(a, b) -> np.ndarray:
    ha = np.asarray(a, np.float32).astype(np.float16).view(np.int16)
    hb = np.asarray(b, np.float32).astype(np.float16).view(np.int16)
    return np.abs(ha.astype(np.int32) - hb.astype(np.int32))


def test_compressed_step_matches_reference():
    """One aligned step with int8 gradient compression in both packages
    from one state (``convert.train_state_from_jax`` carries the zero
    residuals), at lr 1e-3: loss, accuracy and gradient norm within 1e-4
    relative, lr equal, parameters within one fp16 ulp, as
    ``tests/test_torch_train.py`` holds an uncompressed run. The residuals
    agree within one quantum: a gradient that lies within the frameworks'
    summation error of a rounding boundary takes the neighbouring int8
    code, which moves its residual by one quantum (``scale`` >= 2 max|e|)
    and, from the second step on, can move its weight by more than an ulp
    (2 of 360448 weights after two steps on the CPU)."""
    jcfg = j_get_config("olmo-1b").reduced()
    common = dict(steps=1, checkpoint_dir="", learning_rate=1e-3,
                  warmup_steps=0, grad_compression=True)
    jrun = JRunConfig(policy=JPolicy(default=JRule(protect="one4n", n_group=8,
                                                   index=2)),
                      remat=False, **common)
    trun = RunConfig(policy=_align_policy(), **common)
    jstate = j_steps.init_train_state(jax.random.PRNGKey(0), jcfg, jrun)
    assert jstate.ef_error is not None
    tstate = convert.train_state_from_jax(jstate)
    assert set(tstate.ef_error) == set(tstate.params)
    jres = j_loop.run_training(jcfg, jrun, iter(j_synth.MarkovLM(
        jcfg.vocab_size, 32, 4, seed=3)), state=jstate)
    tres = t_loop.run_training(get_config("olmo-1b").reduced(), trun,
                               iter(MarkovLM(jcfg.vocab_size, 32, 4, seed=3)),
                               state=tstate)
    jh, th = jres.history[0], tres.history[0]
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(th[k], jh[k], rtol=METRIC_RTOL, err_msg=k)
    assert np.float32(th["lr"]) == np.float32(jh["lr"]) > 0
    flat = lambda t: convert.tree.flatten(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t))
    j_params, j_ef = flat(jres.state.params), flat(jres.state.ef_error)
    moved = 0
    for p, w in tres.state.params.items():
        ulps = _fp16_ulps(j_params[p], w.numpy())
        assert ulps.max() <= 1, (p, int(ulps.max()))
        moved += int((w.numpy() != np.asarray(tstate.params[p])).sum())
        e_t, e_j = tres.state.ef_error[p].numpy(), j_ef[p]
        quantum = 2 * max(np.abs(e_t).max(), np.abs(e_j).max())
        assert np.abs(e_t - e_j).max() <= 1.01 * quantum + 1e-12, p
    assert moved > 0


# ---------------------------------------------------------------- data

def test_checkpointable_loader_resumes_exactly(tmp_path):
    """The loader's cursor rides in the checkpoint: a restarted loader
    replays the exact next batch (no skips or repeats)."""
    src = MarkovLM(64, 16, 2, seed=9)
    loader = CheckpointableLoader(src)
    consumed = [next(loader) for _ in range(5)]
    ckpt.save({"data": loader.state_dict()["cursor"]}, 5, str(tmp_path))
    restored, _ = ckpt.restore({"data": 0}, str(tmp_path))
    loader2 = CheckpointableLoader(src)
    loader2.load_state_dict({"cursor": int(restored["data"])})
    nxt = next(loader2)
    assert np.array_equal(nxt["tokens"], src.batch(5)["tokens"])
    assert not np.array_equal(nxt["tokens"], consumed[0]["tokens"])


def test_checkpointable_loader_matches_reference():
    """The port's and the reference's loaders over the same MarkovLM give
    the same batches, before and after a cursor restore."""
    jl = j_synth.CheckpointableLoader(j_synth.MarkovLM(64, 16, 2, seed=9))
    tl = CheckpointableLoader(MarkovLM(64, 16, 2, seed=9))
    for _ in range(3):
        jb, tb = next(jl), next(tl)
        for k in ("tokens", "labels"):
            assert np.array_equal(np.asarray(jb[k]), tb[k])
    assert jl.state_dict() == tl.state_dict() == {"cursor": 3}
    jl2 = j_synth.CheckpointableLoader(j_synth.MarkovLM(64, 16, 2, seed=9))
    tl2 = CheckpointableLoader(MarkovLM(64, 16, 2, seed=9))
    jl2.load_state_dict(jl.state_dict())
    tl2.load_state_dict(tl.state_dict())
    for _ in range(2):
        jb, tb = next(jl2), next(tl2)
        for k in ("tokens", "labels"):
            assert np.array_equal(np.asarray(jb[k]), tb[k])
    assert iter(tl2) is tl2
