"""The port's fleet serving (``repro_torch.launch.fleet``), the elastic
coordinator and the engine's fleet hooks, against the JAX reference.

Mirrors the single-device tests of ``tests/test_fleet.py`` on reduced
olmo-1b: content-keyed salts, the coordinator's edges, the prefix trie,
prefix reuse bitwise, the refresh contract, the fleet's JSON fields, routed
== solo bitwise, one restored image per replica, balanced routing, drain
and re-admit bitwise, the all-drained error, and the load generator. The
reference's 8-device subprocess test is held through the single-device
results in ``tests/test_torch_engine_mesh.py`` (a fleet over per-replica
meshes); here ``make_fleet_meshes`` refuses a world of the wrong size.

Against the reference: a routed 2-replica fleet over dynamic one4n at BER
1e-3 gives every request the JAX fleet's tokens and ECC charges, and logits
within allclose(rtol=1e-4, atol=1e-5) (``test_torch_engine.py``'s bound);
which replica serves a request is not compared, since the router scores on
a wall-clock TTFT EWMA. The routing rule itself is held with scripted TTFTs,
and ``ElasticCoordinator.propose_data_axis`` equals the reference's over a
grid of hosts, failures, devices per host and model axes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import elastic as j_elastic  # noqa: E402
from repro.launch import engine as j_engine  # noqa: E402
from repro.launch import fleet as j_fleet  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import deployment as dep_lib  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.elastic import ElasticCoordinator  # noqa: E402
from repro_torch.launch import engine as engine_lib  # noqa: E402
from repro_torch.launch import fleet as fleet_lib  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_engine import (  # noqa: E402
    _jax_serving_params, _reference_compiled_by_parts, _reference_seeds)

CHUNK = 8
MAX_LEN = 40
SLOTS = 2
BER = 1e-3
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def olmo():
    """Reduced olmo-1b from the reference's weights in both packages."""
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(0)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    cfg = get_config("olmo-1b").reduced()
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return jcfg, params, model, jax.random.fold_in(key, 1)


@pytest.fixture(scope="module")
def sparams(olmo):
    """inject -> the port's serving params (fused one4n, BER 1e-3) under the
    reference's seeds."""
    _, params, model, dkey = olmo
    static, dynamic = _reference_seeds(params, dkey, "fused", "one4n")
    return {inject: serve_lib.build_params(
        model, cim=True, ber=BER, protect="one4n", inject=inject,
        static_seeds=static, dynamic_seeds=dynamic, verbose=False)[0]
        for inject in ("static", "dynamic")}


def _load(n=6, seed=7, prefix_len=16, gens=(3, 5)):
    return engine_lib.LoadGen(n_requests=n, prompt_lens=(3, 10),
                              gen_lens=gens, vocab_size=256, seed=seed,
                              prefix_len=prefix_len)


def _fleet(model, params, tmp_path, n=2, **kw):
    kw = {"n_slots": SLOTS, "max_len": MAX_LEN, "chunk": CHUNK, **kw}
    return fleet_lib.Fleet.from_serving_params(
        model, params, n_replicas=n, spool_dir=str(tmp_path), **kw)


def _solo(model, params, reqs):
    with torch.inference_mode():
        return engine_lib.Engine(model, params, n_slots=SLOTS,
                                 max_len=MAX_LEN, chunk=CHUNK,
                                 collect_logits=True).run(reqs)[0]


def _same(a, b):
    assert a.tokens == b.tokens, a.rid
    assert np.array_equal(a.logits, b.logits), a.rid
    assert a.ecc == b.ecc and a.ecc_window == b.ecc_window, a.rid


# ------------------------------------------------------------ against JAX


def test_fleet_matches_reference(olmo, sparams, tmp_path):
    """2 replicas, dynamic one4n, a 16-token shared prefix with per-replica
    prefix caches, in both packages: every request's tokens and ECC equal,
    logits within allclose."""
    jcfg, params, model, dkey = olmo
    reqs = _load().requests()
    with _reference_compiled_by_parts(jcfg):
        jsp = _jax_serving_params(params, dkey, "fused", "one4n", "dynamic",
                                  "")
        jfl = j_fleet.Fleet.from_serving_params(
            jcfg, jsp, n_replicas=2, spool_dir=str(tmp_path / "j"),
            n_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK, collect_logits=True)
        jres, jagg = jfl.run(j_engine.LoadGen(
            n_requests=6, prompt_lens=(3, 10), gen_lens=(3, 5),
            vocab_size=256, seed=7, prefix_len=16).requests())
    fl = _fleet(model, sparams["dynamic"], tmp_path / "t",
                collect_logits=True)
    with torch.inference_mode():
        tres, tagg = fl.run(reqs)
    assert sorted(tres) == sorted(jres) == [r.rid for r in reqs]
    for rid, j in jres.items():
        t = tres[rid]
        for f in ("tokens", "ecc", "ecc_window", "salt", "finish"):
            assert getattr(t, f) == getattr(j, f), (rid, f)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), rtol=RTOL,
                                   atol=ATOL)
    assert tagg["total_tokens"] == jagg["total_tokens"]
    assert sum(tagg["requests_by_replica"].values()) == len(reqs)
    assert set(tagg) >= {"tok_s_virtual", "requests_by_replica", "scrub",
                         "spool"}
    assert tagg["spool"]["bytes"] > 0


def test_propose_data_axis_matches_reference():
    for n_hosts in (1, 2, 3, 5, 8):
        for failed in range(n_hosts + 1):
            for model_axis in (1, 2, 3, 8, 16):
                hosts = [f"h{i}" for i in range(n_hosts)]
                j = j_elastic.ElasticCoordinator(hosts, model_axis=model_axis)
                t = ElasticCoordinator(hosts, model_axis=model_axis)
                for h in hosts[:failed]:
                    assert j.mark_failed(h) == t.mark_failed(h)
                for dph in (1, 2, 4, 5, 32):
                    assert t.propose_data_axis(dph) == \
                        j.propose_data_axis(dph), (n_hosts, failed,
                                                   model_axis, dph)
                    assert t.reconfigure(dph) == j.reconfigure(dph)
                assert t.healthy_hosts == j.healthy_hosts


def test_router_rule_with_scripted_ttfts(olmo, sparams, tmp_path):
    """The router sends each arrived request to the lowest
    (depth + 1) * max(EWMA TTFT, 1e-3), ties to the first name; the EWMA
    starts at the first TTFT and then moves by alpha."""
    _, _, model, _ = olmo
    fl = _fleet(model, sparams["static"], tmp_path, n=3, prefix_cache=False)
    reps = fl.replicas
    reps["replica0"].observe_ttft(0.5, fl.ewma_alpha)
    reps["replica1"].observe_ttft(0.125, fl.ewma_alpha)
    reps["replica1"].observe_ttft(0.625, fl.ewma_alpha)  # .75*.125 + .25*.625
    assert reps["replica1"].ewma_ttft == 0.25
    assert reps["replica1"].served == 2
    # replica2 has served nothing: its score floors at 1e-3, so it takes
    # the whole burst (depth 3 scores 4e-3)
    reqs = _load(n=4, prefix_len=0).requests()
    fl.start()
    for r in reqs:
        fl.submit(r)
    assert fl._route(0.0) == [0, 1, 2, 3]
    assert [r.rid for r, _ in reps["replica2"].engine.queue] == [0, 1, 2, 3]
    # without replica2: rid 0 to replica1 (0.25 < 0.5), rid 1 ties at 0.5
    # and goes to the first name, replica0; rids 2 and 3 to replica1
    # (0.5 and 0.75 against replica0's 1.0)
    fl.fail("replica2")
    assert [r.rid for r in reqs] == [q.rid for q, _ in fl._queue]
    fl._route(0.0)
    assert [r.rid for r, _ in reps["replica1"].engine.queue] == [0, 2, 3]
    assert [r.rid for r, _ in reps["replica0"].engine.queue] == [1]


# ------------------------------------------------------------ salts


def test_prefix_salt_deterministic_and_content_keyed():
    toks = np.arange(12, dtype=np.int32)
    a = dep_lib.prefix_salt(toks)
    assert a == dep_lib.prefix_salt(list(range(12)))
    assert a != dep_lib.prefix_salt(toks[:11])
    bumped = toks.copy()
    bumped[0] += 1
    assert a != dep_lib.prefix_salt(bumped)
    assert 0 <= a <= 0xFFFFFFFF


def test_prefix_salt_does_not_alias_request_salts():
    reqs = {int(dep_lib.request_salt(rid)) for rid in range(64)}
    prefs = {dep_lib.prefix_salt(np.arange(n) % 7) for n in range(1, 65)}
    assert not reqs & prefs


# ------------------------------------------------------------ elastic edges


def test_propose_data_axis_zero_survivors():
    co = ElasticCoordinator(["h0", "h1"], model_axis=2)
    for h in ("h0", "h1"):
        co.mark_failed(h)
    assert co.healthy_hosts == []
    assert co.propose_data_axis(4) == 0
    gen, dp = co.reconfigure(4)
    assert dp == 0 and gen == 1


def test_propose_data_axis_model_axis_exceeds_survivors():
    co = ElasticCoordinator(["h0", "h1"], model_axis=8)
    assert co.propose_data_axis(4) == 1
    co.mark_failed("h1")
    assert co.propose_data_axis(4) == 0


def test_propose_data_axis_non_power_of_two():
    co = ElasticCoordinator([f"h{i}" for i in range(3)], model_axis=2)
    assert co.propose_data_axis(2) == 2
    assert co.propose_data_axis(5) == 4
    assert co.propose_data_axis(1) == 1


def test_heartbeat_readmits_failed_host():
    co = ElasticCoordinator(["h0", "h1"], model_axis=1)
    assert co.mark_failed("h0") is True
    assert co.mark_failed("h0") is False
    assert co.healthy_hosts == ["h1"]
    co.heartbeat("h0")
    assert co.healthy_hosts == ["h0", "h1"]
    assert co.drain_recovered() == ["h0"]
    assert co.drain_recovered() == []
    co.heartbeat("nope")


def test_timeout_check_marks_failed_once():
    t = [0.0]
    co = ElasticCoordinator(["h0", "h1"], model_axis=1,
                            heartbeat_timeout=10.0, clock=lambda: t[0])
    t[0] = 5.0
    co.heartbeat("h1")
    t[0] = 11.0
    assert co.check() == ["h0"]
    assert co.check() == []


# ------------------------------------------------------------ prefix cache


def test_prefix_cache_hash_consing_and_trie_paths():
    pc = engine_lib.PrefixCache()
    a = np.arange(8, dtype=np.int32)
    b = a + 1
    n1 = pc.insert(None, a, state="kv_a", salt=1)
    assert pc.insert(None, a, state="other", salt=1) is n1
    assert pc.inserts == 1
    n2 = pc.insert(n1, b, state="kv_b", salt=2)
    assert pc.lookup(None, a) is n1
    assert pc.lookup(n1, b) is n2
    assert pc.lookup(None, b) is None
    assert pc.lookup(n2, a) is None
    assert len(pc) == 2 and pc.hits == 2 and pc.misses == 2


def test_prefix_cache_lru_evicts_leaves_only():
    pc = engine_lib.PrefixCache(max_chunks=2)
    root = pc.insert(None, [1], state=0, salt=0)
    pc.insert(root, [2], state=0, salt=0)
    pc.lookup(None, [1])
    pc.insert(None, [3], state=0, salt=0)
    assert pc.evictions == 1
    assert pc.lookup(None, [1]) is not None
    assert pc.lookup(root, [2]) is None
    assert pc.lookup(None, [3]) is not None


def test_prefix_cache_invalidate():
    pc = engine_lib.PrefixCache()
    n = pc.insert(None, [1, 2], state=0, salt=0)
    pc.insert(n, [3, 4], state=0, salt=0)
    pc.invalidate()
    assert len(pc) == 0 and pc.invalidations == 1
    assert pc.lookup(None, [1, 2]) is None


# ------------------------------------------------------------ engine reuse


@pytest.mark.parametrize("inject", ["static", "dynamic"])
def test_prefix_reuse_bitwise(olmo, sparams, inject):
    """Trie-warm admission == cold prefill, bitwise: tokens, every logit
    vector and the replayed ECC charges."""
    _, _, model, _ = olmo
    reqs = _load().requests()

    def run(pc):
        eng = engine_lib.Engine(model, sparams[inject], n_slots=3,
                                max_len=MAX_LEN, chunk=CHUNK,
                                collect_logits=True, prefix_cache=pc)
        with torch.inference_mode():
            return eng.run(reqs)[0], eng

    cold, _ = run(None)
    warm, eng = run(True)
    hits = 0
    for rid in cold:
        _same(cold[rid], warm[rid])
        hits += warm[rid].prefix_tokens > 0
    assert hits > 0, "16-token shared prefix produced no trie hits"
    st = eng.prefix_cache.stats()
    assert st["hits"] > 0 and st["chunks"] > 0


def test_prefix_reuse_within_one_run(olmo, sparams):
    _, _, model, _ = olmo
    eng = engine_lib.Engine(model, sparams["static"], n_slots=SLOTS,
                            max_len=MAX_LEN, chunk=CHUNK, prefix_cache=True)
    res, agg = eng.run(_load().requests())
    first = min(res)
    assert res[first].prefix_tokens == 0
    assert agg["prefix_hits"] >= 1
    assert agg["prefix_tokens"] == sum(r.prefix_tokens for r in res.values())


def test_refresh_params_invalidates_trie(olmo, sparams):
    _, _, model, _ = olmo
    eng = engine_lib.Engine(model, sparams["static"], n_slots=SLOTS,
                            max_len=MAX_LEN, chunk=CHUNK, prefix_cache=True)
    eng.run(_load(n=3).requests())
    assert len(eng.prefix_cache) > 0
    eng.refresh_params(sparams["static"])
    assert len(eng.prefix_cache) == 0
    assert eng.prefix_cache.invalidations == 1


def test_refresh_params_refuses_busy_engine(olmo, sparams):
    _, _, model, _ = olmo
    eng = engine_lib.Engine(model, sparams["static"], n_slots=SLOTS,
                            max_len=MAX_LEN, chunk=CHUNK)
    eng.submit(engine_lib.Request(rid=0, tokens=[1, 2, 3], max_new=2))
    with pytest.raises(engine_lib.EngineError, match="busy"):
        eng.refresh_params(sparams["static"])


def test_result_json_carries_fleet_fields(olmo, sparams):
    _, _, model, _ = olmo
    eng = engine_lib.Engine(model, sparams["static"], n_slots=SLOTS,
                            max_len=MAX_LEN, chunk=CHUNK, prefix_cache=True,
                            replica="r9")
    res, agg = eng.run(_load(n=3).requests())
    assert agg["replica"] == "r9"
    rows = [r.to_json() for r in res.values()]
    assert all(row["replica"] == "r9" for row in rows)
    assert all(row["salt"] == int(dep_lib.request_salt(row["rid"]))
               for row in rows)
    assert any(row["prefix_hit"] for row in rows)
    assert all(row["prefix_hit"] == (row["prefix_tokens"] > 0)
               for row in rows)


# ------------------------------------------------------------ fleet


def test_fleet_routed_equals_solo_bitwise(olmo, sparams, tmp_path):
    """Dynamic injection, 2 replicas off one spooled image: routed results
    == a solo engine serving the same load off the original params."""
    _, _, model, _ = olmo
    reqs = _load().requests()
    solo = _solo(model, sparams["dynamic"], reqs)
    fl = _fleet(model, sparams["dynamic"], tmp_path, collect_logits=True)
    with torch.inference_mode():
        routed, agg = fl.run(reqs)
    assert sorted(routed) == sorted(r.rid for r in reqs)
    for rid in solo:
        _same(solo[rid], routed[rid])
    assert len({r.replica for r in routed.values()}) == 2
    assert agg["n_replicas"] == 2 and agg["drains"] == 0


def test_fleet_replicas_share_one_image(olmo, sparams, tmp_path):
    """Every replica restores its own copy of the source params, equal leaf
    by leaf: packed planes, the dynamic seed table, everything."""
    _, _, model, _ = olmo
    src = sparams["dynamic"]
    fl = _fleet(model, src, tmp_path)
    copies = [rep.engine.params for rep in fl.replicas.values()]
    for got in copies:
        assert set(got) == set(src)
        assert got["_cim"] == src["_cim"]
        for path in ("embed", "unembed"):
            for name in ("man", "sign", "exp", "codewords"):
                a, b = getattr(src[path], name), getattr(got[path], name)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and torch.equal(a, b)
    # each replica holds its own tensors: no replica aliases another's
    assert copies[0]["unembed"].man.data_ptr() != \
        copies[1]["unembed"].man.data_ptr()
    assert ckpt.latest_step(fl.spool_dir) == 0


def test_fleet_balances_closed_burst(olmo, sparams, tmp_path):
    _, _, model, _ = olmo
    load = _load(n=8, prefix_len=0, gens=(4, 4))
    fl = _fleet(model, sparams["static"], tmp_path, prefix_cache=False)
    _, agg = fl.run(load.requests())
    by_rep = agg["requests_by_replica"]
    assert sum(by_rep.values()) == 8
    assert min(by_rep.values()) >= 2, by_rep


def test_fleet_drain_requeue_bitwise(olmo, sparams, tmp_path):
    """Force-fail a replica mid-run: its in-flight and queued requests
    re-route and the results still equal the uninterrupted solo run."""
    _, _, model, _ = olmo
    reqs = _load().requests()
    solo = _solo(model, sparams["dynamic"], reqs)
    fl = _fleet(model, sparams["dynamic"], tmp_path, collect_logits=True)
    fl.start()
    for r in reqs:
        fl.submit(r)
    with torch.inference_mode():
        fl.tick()
        fl.tick()
        fl.fail("replica0")
        assert fl.drains == 1 and fl.requeued >= 1
        fl.tick()
        fl.recover("replica0")
        while fl.busy:
            fl.tick()
    assert sorted(fl.results) == sorted(r.rid for r in reqs)
    for rid in solo:
        _same(solo[rid], fl.results[rid])
    assert "replica0" in fl._admitting


def test_fleet_all_drained_raises(olmo, sparams, tmp_path):
    _, _, model, _ = olmo
    fl = _fleet(model, sparams["static"], tmp_path)
    fl.fail("replica0")
    fl.fail("replica1")
    with pytest.raises(fleet_lib.FleetError, match="no admitting"):
        fl.run(_load(n=2).requests())


def test_fleet_meshes_wait():
    """Per-replica meshes need a world of n x D x M ranks (the reference
    asserts enough devices), and ``meshes`` must be what
    ``make_fleet_meshes`` returns (``tests/test_torch_engine_mesh.py``
    serves a fleet over meshes)."""
    from repro_torch.launch import mesh as mesh_lib
    try:
        with pytest.raises(ValueError, match="needs 16 ranks"):
            fleet_lib.make_fleet_meshes("1x8", 2, "cpu")
    finally:
        mesh_lib.destroy_world()
    with pytest.raises(ValueError, match="make_fleet_meshes"):
        fleet_lib.Fleet.from_serving_params(None, {}, n_replicas=1,
                                            meshes=[None])


def test_serve_fleet_probe_on_cpu(tmp_path, capsys):
    """``serve --fleet 2 --probe`` on the CPU: the routed request equals
    its replay through a one-replica fleet from the same spool."""
    import json
    out = tmp_path / "fleet.json"
    results, agg = serve_lib.main([
        "--fleet", "2", "--reduced", "--device", "cpu", "--cim", "--ber",
        "1e-3", "--inject", "dynamic", "--slots", "2", "--chunk", "8",
        "--requests", "5", "--prompt-range", "4,12", "--gen-range", "2,4",
        "--shared-prefix", "8", "--probe", "3", "--engine-json", str(out)])
    text = capsys.readouterr().out
    assert "fleet: 5 requests over 2 replicas" in text
    assert "solo replay MATCHES" in text
    assert sorted(results) == [0, 1, 2, 3, 4]
    payload = json.loads(out.read_text())
    assert payload["probe"]["ok"] and payload["config"]["fleet"] == 2
    assert sum(payload["aggregate"]["requests_by_replica"].values()) == 5


# ------------------------------------------------------------ load gen


def test_loadgen_fleet_fanout_determinism():
    a = _load(seed=3).requests()
    b = _load(seed=3).requests()
    for ra, rb in zip(a, b):
        assert ra.rid == rb.rid and ra.max_new == rb.max_new
        assert ra.arrival == rb.arrival
        assert np.array_equal(ra.tokens, rb.tokens)


def test_loadgen_shared_prefix_semantics():
    load = _load(n=4, seed=9, prefix_len=12)
    reqs = load.requests()
    first = reqs[0].tokens[:12]
    assert all(np.array_equal(r.tokens[:12], first) for r in reqs)
    assert load.max_len() >= max(r.tokens.size + r.max_new for r in reqs)
    base = engine_lib.LoadGen(n_requests=4, prompt_lens=(3, 10),
                              gen_lens=(3, 5), vocab_size=256, seed=9)
    again = engine_lib.LoadGen(n_requests=4, prompt_lens=(3, 10),
                               gen_lens=(3, 5), vocab_size=256, seed=9,
                               prefix_len=0)
    for ra, rb in zip(base.requests(), again.requests()):
        assert np.array_equal(ra.tokens, rb.tokens)
