"""The port's online ECC scrubbing (``repro_torch.launch.scrub``) and the
engine's scrub hooks, against the JAX reference.

Mirrors ``tests/test_scrub.py`` on reduced olmo-1b (scrub-on strictly fewer
uncorrectable events than scrub-off under the same wear, the per-request
``ecc_window`` series, ``record_scrub`` and the forced refresh, an exact
re-encode, validation, the fleet rollup), and holds against the reference,
bitwise:

* ``DriftAging.age`` at ticks 1-3 under the reference's per-tick seeds
  (``fold_in(PRNGKey(77), tick)`` split over the params' flat leaves), every
  plane of every store;
* ``ScrubController.scrub`` of one aged image: the event (every field but
  ``wall_s``) and the fresh image;
* the reference's own soak (``_soak`` of ``tests/test_scrub.py``: 4
  requests, 2 slots, chunk 8, max_len 24, ``DriftAging(ber=1e-3,
  drift_rate=0.2)``, threshold 4), scrub-on and scrub-off, port engine
  against the JAX engine: the scrub events (step, tick, paths, rows, words
  healed, cleared counts), per request the tokens, ``ecc``, ``ecc_window``,
  ``scrubs`` and ``finite``, and ``aggregate()['ecc']`` and ``store_ecc``.
  Logits agree within the engine file's allclose(rtol=1e-4, atol=1e-5).

The reference engine runs with ``test_torch_engine.py``'s recipe (its
steps unjitted, the block stack and the reads under ``jax.jit``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import faultmodels as j_fm  # noqa: E402
from repro.launch import engine as j_engine  # noqa: E402
from repro.launch import scrub as j_scrub  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import faultmodels as t_fm  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import fleet as t_fleet  # noqa: E402
from repro_torch.launch import scrub as t_scrub  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from test_torch_engine import _reference_compiled_by_parts  # noqa: E402

CHUNK, MAX_LEN, SLOTS = 8, 24, 2
AGE_KEY, AGE_BER, DRIFT_RATE, THRESHOLD = 77, 1e-3, 0.2, 4
RTOL, ATOL = 1e-4, 1e-5
EVENT_FIELDS = ("step", "tick", "paths", "rows", "words_healed",
                "corrected_cleared", "uncorrectable_cleared")
RESULT_FIELDS = ("tokens", "ecc", "ecc_window", "scrubs", "finite")
PLANES = ("man", "sign", "exp", "codewords")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_store_seeds(dep, key):
    """The reference's static-injection plane seeds per store path: one key
    split over all flat leaves of the params, tree order."""
    flat, _ = dep._flat()
    keys = jax.random.split(key, len(flat))
    return {p: {k: int(v) for k, v in j_cim.plane_seeds(keys[i]).items()}
            for i, (p, leaf) in enumerate(zip(dep.paths, flat))
            if isinstance(leaf, j_cim.CIMStore)}


@pytest.fixture(scope="module")
def setup():
    """Reduced olmo-1b deployed at BER 0 (one4n, n_group 8, index 2) in both
    packages from the reference's weights, and the reference's per-tick
    aging seeds."""
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(0)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    jdep = j_serve.make_deployment(params, ber=0.0, protect="one4n",
                                   n_group=8, index=2,
                                   key=jax.random.fold_in(key, 1),
                                   inject_mode="static", field="full")
    cfg = get_config("olmo-1b").reduced()
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    tdep = t_serve.make_deployment(model.cim_leaves(), ber=0.0,
                                   protect="one4n", n_group=8, index=2,
                                   seeds={}, inject_mode="static",
                                   field="full")
    seeds = {}

    def tick_seeds(tick):
        if tick not in seeds:
            seeds[tick] = jax_store_seeds(
                jdep, jax.random.fold_in(jax.random.PRNGKey(AGE_KEY), tick))
        return seeds[tick]
    return jcfg, jdep, model, tdep, tick_seeds


def _same_stores(jdep, tdep):
    jstores = {p: s for p, _, s in jdep.store_leaves()}
    tstores = {p: s for p, _, s in tdep.store_leaves()}
    assert set(jstores) == set(tstores) == {"embed", "unembed"}
    for p, js in jstores.items():
        ts = tstores[p]
        for name in PLANES:
            a, b = getattr(js, name), getattr(ts, name)
            assert (a is None) == (b is None), (p, name)
            if a is not None:
                a = np.asarray(a)
                assert np.array_equal(a.view(np.int32) if a.dtype == np.uint32
                                      else a, b.numpy()), (p, name)


def _requests(mod, n=4, seed=5):
    return mod.LoadGen(n_requests=n, prompt_lens=(3, 12), gen_lens=(4, 6),
                       vocab_size=256, seed=seed).requests()


def _port_soak(model, dep, tick_seeds, *, scrub: bool, n=4,
               check_finite=False):
    aging = t_scrub.DriftAging(seeds=tick_seeds, ber=AGE_BER,
                               model=t_fm.FaultProcess.drift(
                                   drift_rate=DRIFT_RATE))
    policy = t_scrub.ScrubPolicy(threshold=THRESHOLD if scrub else 10 ** 9)
    ctl = t_scrub.ScrubController(dep, policy, aging=aging, serving_kw={})
    eng = t_engine.Engine(model, dep.serving_params(), n_slots=SLOTS,
                          max_len=MAX_LEN, chunk=CHUNK, collect_logits=True,
                          check_finite=check_finite)
    with torch.inference_mode():
        results, agg = eng.run(_requests(t_engine, n), on_step=ctl)
    assert sorted(results) == list(range(n))
    return eng, results, agg, ctl


@pytest.fixture(scope="module")
def soaks(setup):
    """scrub on/off -> ((JAX engine, results, aggregate), (port's))."""
    jcfg, jdep, model, tdep, tick_seeds = setup
    out = {}
    with _reference_compiled_by_parts(jcfg):
        for scrub in (False, True):
            aging = j_scrub.DriftAging(
                key=jax.random.PRNGKey(AGE_KEY), ber=AGE_BER,
                model=j_fm.FaultProcess.drift(drift_rate=DRIFT_RATE))
            policy = j_scrub.ScrubPolicy(
                threshold=THRESHOLD if scrub else 10 ** 9)
            ctl = j_scrub.ScrubController(jdep, policy, aging=aging,
                                          serving_kw={})
            eng = j_engine.Engine(jcfg, jdep.serving_params(), n_slots=SLOTS,
                                  max_len=MAX_LEN, chunk=CHUNK,
                                  collect_logits=True, check_finite=False)
            res, agg = eng.run(_requests(j_engine), on_step=ctl)
            out[scrub] = ((eng, res, agg),
                          _port_soak(model, tdep, tick_seeds, scrub=scrub)[:3])
    return out


# ------------------------------------------------------ against the reference


def test_drift_aging_matches_reference(setup):
    """Ticks 1-3 of cumulative wear: every plane of every store bitwise."""
    _, jdep, _, tdep, tick_seeds = setup
    model = dict(model=j_fm.FaultProcess.drift(drift_rate=DRIFT_RATE))
    jage = j_scrub.DriftAging(key=jax.random.PRNGKey(AGE_KEY), ber=AGE_BER,
                              **model)
    tage = t_scrub.DriftAging(seeds=tick_seeds, ber=AGE_BER,
                              model=t_fm.FaultProcess.drift(
                                  drift_rate=DRIFT_RATE))
    j, t = jdep, tdep
    for tick in (1, 2, 3):
        j, t = jage.age(j, tick), tage.age(t, tick)
        _same_stores(j, t)
    st = t.stats()
    assert st["corrected"] > 0 and st == {k: int(v) for k, v in
                                          j.stats().items()}


def test_scrub_event_and_fresh_image_match_reference(setup):
    """One scrub of an image aged three ticks: the event and the fresh
    image equal the reference's."""
    _, jdep, _, tdep, tick_seeds = setup
    jage = j_scrub.DriftAging(key=jax.random.PRNGKey(AGE_KEY), ber=AGE_BER,
                              model=j_fm.FaultProcess.drift(
                                  drift_rate=DRIFT_RATE))
    tage = t_scrub.DriftAging(seeds=tick_seeds, ber=AGE_BER,
                              model=t_fm.FaultProcess.drift(
                                  drift_rate=DRIFT_RATE))
    j, t = jdep, tdep
    for tick in (1, 2, 3):
        j, t = jage.age(j, tick), tage.age(t, tick)
    jctl, tctl = j_scrub.ScrubController(j), t_scrub.ScrubController(t)
    jev, tev = jctl.scrub(["embed", "unembed"]), tctl.scrub(
        ["embed", "unembed"])
    assert tev["words_healed"] > 0 and tev["uncorrectable_cleared"] > 0
    for k in ("paths", "rows", "words_healed", "corrected_cleared",
              "uncorrectable_cleared", "tick"):
        assert tev[k] == jev[k], k
    _same_stores(jctl.dep, tctl.dep)
    # the fresh image is the deploy-time encode of the decoded weights
    for p, _, s in tctl.dep.store_leaves():
        assert t_cim.store_stats(s) == {"corrected": 0, "uncorrectable": 0}


@pytest.mark.parametrize("scrub", [False, True])
def test_soak_matches_reference(soaks, scrub):
    (jeng, jres, jagg), (teng, tres, tagg) = soaks[scrub]
    assert len(teng.scrub_events) == len(jeng.scrub_events)
    for je, te in zip(jeng.scrub_events, teng.scrub_events):
        for k in EVENT_FIELDS:
            assert te[k] == je[k], (k, te, je)
    assert sorted(jres) == sorted(tres) == [0, 1, 2, 3]
    for rid, j in jres.items():
        t = tres[rid]
        for field in RESULT_FIELDS:
            assert getattr(t, field) == getattr(j, field), (scrub, rid, field)
        jl = np.asarray(j.logits)
        assert np.array_equal(np.isnan(t.logits), np.isnan(jl))
        np.testing.assert_allclose(t.logits, jl, rtol=RTOL, atol=ATOL)
    assert tagg["ecc"] == jagg["ecc"]
    assert tagg["store_ecc"] == jagg["store_ecc"]
    assert tagg["scrub"]["events"] == jagg["scrub"]["events"]
    for k in ("rows_reencoded", "corrected_cleared", "uncorrectable_cleared"):
        assert tagg["scrub"][k] == jagg["scrub"][k], k
    assert teng.steps == jeng.steps


# ------------------------------------------------------ the reference's tests


def test_scrub_on_beats_scrub_off(soaks):
    _, res_off, agg_off = soaks[False][1]
    _, res_on, agg_on = soaks[True][1]
    assert agg_off["scrub"]["events"] == 0
    assert agg_on["scrub"]["events"] > 0
    assert agg_on["scrub"]["rows_reencoded"] > 0
    assert agg_on["ecc"]["uncorrectable"] < agg_off["ecc"]["uncorrectable"]
    assert agg_off["ecc"]["uncorrectable"] > 0   # the soak actually wears
    for res in (res_on, res_off):
        for r in res.values():
            assert len(r.tokens) >= 1
    for r in res_on.values():
        assert r.finite and all(np.isfinite(lg).all() for lg in r.logits)
    sc = agg_on["scrub"]
    assert sc["wall_s"] > 0
    assert sc["corrected_cleared"] + sc["uncorrectable_cleared"] > 0


def test_ecc_window_in_request_json(setup):
    _, _, model, tdep, tick_seeds = setup
    _, results, _, _ = _port_soak(model, tdep, tick_seeds, scrub=True, n=2)
    for r in results.values():
        j = r.to_json()
        assert j["ecc_window"], "per-request ECC time series missing"
        for row in j["ecc_window"]:
            assert set(row) == {"pos", "reads", "corrected", "uncorrectable"}
            assert all(isinstance(v, int) for v in row.values())
        assert sum(w["reads"] for w in j["ecc_window"]) == j["ecc"]["reads"]
        assert sum(w["corrected"] for w in j["ecc_window"]) == \
            j["ecc"]["corrected"]
        assert isinstance(j["scrubs"], int) and j["scrubs"] == r.scrubs


def test_record_scrub_resets_store_counters(setup):
    _, _, model, tdep, _ = setup
    eng = t_engine.Engine(model, tdep.serving_params(), n_slots=SLOTS,
                          max_len=MAX_LEN, chunk=CHUNK, prefix_cache=True)
    eng.run(_requests(t_engine, 2))
    assert any(v["reads"] > 0 for v in eng.store_ecc.values())
    path = next(iter(eng.store_ecc))
    eng.store_ecc[path]["corrected"] = 7
    eng.record_scrub({"paths": [path], "rows": 1, "corrected_cleared": 7,
                      "uncorrectable_cleared": 0, "wall_s": 0.0})
    assert eng.store_ecc[path] == {"reads": 0, "corrected": 0,
                                   "uncorrectable": 0}
    assert eng.aggregate()["scrub"]["events"] == 1
    # refresh_params(force=True) mid-flight drops the prefix cache
    eng.prefix_cache.insert(None, [1, 2, 3, 4], eng.caches, 0)
    assert len(eng.prefix_cache) > 0
    eng.submit(t_engine.Request(rid=9, tokens=np.arange(3), max_new=2))
    eng.refresh_params(tdep.serving_params(), force=True)
    assert len(eng.prefix_cache) == 0


def test_scrub_controller_reencodes_exactly(setup):
    """Scrubbing a damaged image restores the clean planes bit for bit for
    every store whose rows are all still correctable."""
    _, jdep, _, tdep, _ = setup
    clean = {p: s for p, _, s in tdep.store_leaves()}
    damaged = tdep.inject(jax_store_seeds(jdep, jax.random.PRNGKey(3)), 5e-4,
                          field="exponent_sign")
    pre = {p: t_cim.store_stats(s) for p, _, s in damaged.store_leaves()}
    assert any(st["corrected"] > 0 for st in pre.values())
    ctl = t_scrub.ScrubController(damaged)
    ev = ctl.scrub(list(clean))
    assert set(ev["paths"]) == set(clean)
    healed = 0
    for p, _, s in ctl.dep.store_leaves():
        if pre[p]["uncorrectable"] == 0:
            healed += 1
            for name, plane in t_cim.plane_dict(clean[p]).items():
                assert torch.equal(plane, t_cim.plane_dict(s)[name]), (p, name)
    assert healed > 0


def test_policy_and_aging_validation():
    with pytest.raises(ValueError):
        t_scrub.ScrubPolicy(threshold=0)
    with pytest.raises(ValueError):
        t_scrub.ScrubPolicy(interval=0)
    with pytest.raises(ValueError):
        t_scrub.DriftAging(seeds=0, ber=1e-3, every=0)
    pol = t_scrub.ScrubPolicy(threshold=3)
    assert pol.due({"a": {"corrected": 2, "uncorrectable": 1},
                    "b": {"corrected": 0, "uncorrectable": 0}}) == ["a"]
    # the integer seed form: a numpy-derived seed set per tick and store
    a = t_scrub.tick_seeds(5, 1, ["embed", "unembed"])
    assert a == t_scrub.tick_seeds(5, 1, ["embed", "unembed"])
    assert a != t_scrub.tick_seeds(5, 2, ["embed", "unembed"])
    assert a["embed"] != a["unembed"]
    assert all(0 <= v < 2 ** 32 for s in a.values() for v in s.values())


def test_integer_seed_aging_and_check_finite(setup):
    """``DriftAging`` from an integer seed wears the image tick by tick, and
    an engine on an image worn far enough to decode non-finite logits
    records ``finite=False`` under ``check_finite=False`` and raises by
    default."""
    _, _, model, tdep, _ = setup
    aging = t_scrub.DriftAging(seeds=11, ber=0.2, model="drift:drift_rate=0")
    worn = aging.age(tdep, 1)
    assert worn.stats()["uncorrectable"] > 0
    params = worn.serving_params()
    reqs = _requests(t_engine, 2)
    eng = t_engine.Engine(model, params, n_slots=SLOTS, max_len=MAX_LEN,
                          chunk=CHUNK, check_finite=False)
    with torch.inference_mode():
        res, _ = eng.run(reqs)
    assert not all(r.finite for r in res.values())
    assert any(not r.to_json()["finite"] for r in res.values())
    with pytest.raises(t_engine.EngineError, match="non-finite"):
        t_engine.Engine(model, params, n_slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK).run(reqs)


def test_fleet_aggregate_scrub_rollup(setup, tmp_path):
    _, _, model, tdep, _ = setup
    fl = t_fleet.Fleet.from_serving_params(
        model, tdep.serving_params(), n_replicas=1, spool_dir=str(tmp_path),
        n_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK)
    fl.run(_requests(t_engine, 2))
    agg = fl.aggregate()
    assert set(agg["scrub"]) == {"events", "rows_reencoded",
                                 "corrected_cleared",
                                 "uncorrectable_cleared", "wall_s"}
    assert agg["scrub"]["events"] == 0
    # a scrub logged on the replica rolls up into the fleet's aggregate
    eng = fl.replicas["replica0"].engine
    eng.record_scrub({"paths": ["embed"], "rows": 8, "corrected_cleared": 3,
                      "uncorrectable_cleared": 1, "wall_s": 0.5})
    sc = fl.aggregate()["scrub"]
    assert (sc["events"], sc["rows_reencoded"], sc["corrected_cleared"],
            sc["uncorrectable_cleared"]) == (1, 8, 3, 1)


def test_forced_swap_keeps_slots_and_charges_new_image(setup):
    """A forced swap between steps: slot positions, salts and tokens stay;
    the next charge is the new image's (a static image's constant)."""
    _, jdep, model, tdep, _ = setup
    eng = t_engine.Engine(model, tdep.serving_params(), n_slots=SLOTS,
                          max_len=MAX_LEN, chunk=CHUNK)
    for r in _requests(t_engine, 2):
        eng.submit(r, now=0.0)
    eng.step(now=0.0)
    before = (eng.caches["pos_host"].copy(), eng._salts.copy(),
              eng._tokens.copy())
    worn = tdep.inject(jax_store_seeds(jdep, jax.random.PRNGKey(9)), 1e-3)
    eng.refresh_params(worn.serving_params(), force=True)
    assert np.array_equal(eng.caches["pos_host"], before[0])
    assert np.array_equal(eng._salts, before[1])
    assert np.array_equal(eng._tokens, before[2])
    per_read = {p: t_cim.store_stats(s) for p, _, s in worn.store_leaves()}
    totals = {p: dict(v) for p, v in eng.store_ecc.items()}
    ev = eng.step(now=0.0)
    n = len(ev["decoded"])
    for p, st in per_read.items():
        assert eng.store_ecc[p]["corrected"] == \
            totals[p]["corrected"] + n * st["corrected"]
        assert eng.store_ecc[p]["uncorrectable"] == \
            totals[p]["uncorrectable"] + n * st["uncorrectable"]
    assert dataclasses.asdict(t_scrub.ScrubPolicy()) == {
        "threshold": 16, "interval": 1, "max_scrubs": 0}
