"""The engine and the fleet on meshes against one device, the port's and the
reference's.

The ranks of a mesh run here in threads of one process
(``sharding.thread_ranks``; each thread its own ambient mesh through
``sharding.rank_thread``), every one building its own placed serving params
(``serve.build_params(mesh=)``: each store its column block) and its own
engine. Held on reduced olmo-1b, two slots, chunk 8:

* a 1x2 mesh (stores split over ``"model"``) on a dynamic one4n arm with a
  prefix cache, a static one4n arm and the hbm arm, and a 2x1 mesh (the
  slots split over ``"data"``) on the dynamic arm: every rank's tokens,
  logits and ECC charges (per request, and each read's window) bitwise the
  port's single-device engine's (the 2x1 mesh's logits to fp32 rounding:
  its decode products run at one row a rank, ``GEMM_RTOL``);
* the dynamic arm on one device against the reference's single-device
  engine (unjitted, its reads through ``use_kernel=False``, the methods of
  ``tests/test_torch_engine.py``): tokens and ECC charges equal, logits
  within that file's allclose;
* a request served solo on the 1x2 mesh equals it co-batched; a prefix
  hit replays the summed charge; an open-loop run on the 1x2 mesh (rank
  0's clock decides the arrivals) gives every rank the same schedule and
  the single-device results;
* a fleet of 2 replicas, each on its own 1x1 block of a 2-rank world: every
  rank ends with every request's result, bitwise the single-device
  engine's; ``make_fleet_meshes`` refuses a world of the wrong size.
"""
import contextlib
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.kernels.cim_read import ops as j_cr_ops  # noqa: E402
from repro.launch import engine as j_engine  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import fleet as t_fleet  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

BER, SLOTS, CHUNK, SEED = 1e-3, 2, 8, 0
PREFIX = 16
LOAD = dict(n_requests=4, prompt_lens=(3, 20), gen_lens=(2, 5),
            vocab_size=256, seed=3, prefix_len=PREFIX)
MAX_LEN = PREFIX + 20 + 5 + 1
ARMS = {   # name -> (serve_path, protect, inject)
    "dynamic": ("fused", "one4n", "dynamic"),
    "static": ("fused", "one4n", "static"),
    "hbm": ("hbm", "one4n", "static"),
}
RTOL, ATOL = 1e-4, 1e-5
# A data split decodes one slot a rank where one device decodes both: the
# block stack's products then run at another row count, whose fp32 sums the
# library orders otherwise, so those logits agree to rounding (measured
# below 1e-6 of the largest logit here) while tokens and ECC stay equal.
GEMM_RTOL = 1e-5
EQUAL = ("tokens", "ecc", "ecc_window", "salt", "finish")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(SEED)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    cfg = get_config("olmo-1b").reduced()
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    dkey = jax.random.fold_in(key, 1)
    seeds = {}
    for path, protect, _ in ARMS.values():
        pol = j_serve.serving_policy(protect=protect, n_group=8, index=2,
                                     serve_path=path)
        dep = jax.eval_shape(lambda p: j_dep.CIMDeployment.deploy(p, pol),
                             params)
        flat, _ = dep._flat()
        keys = jax.random.split(dkey, len(flat))
        static = {p: {k: int(v) for k, v in j_cim.plane_seeds(keys[i]).items()}
                  for i, (p, leaf) in enumerate(zip(dep.paths, flat))
                  if isinstance(leaf, j_cim.CIMStore)}
        dynamic = {k: int(v) for k, v in
                   j_cim.plane_seeds(jax.random.fold_in(dkey, 99)).items()}
        seeds[path] = (static, dynamic)
    return jcfg, params, model, dkey, seeds


def _requests(**kw):
    return t_engine.LoadGen(**{**LOAD, **kw}).requests()


def _params(olmo, arm, mesh=None):
    _, _, model, _, seeds = olmo
    path, protect, inject = ARMS[arm]
    static, dynamic = seeds[path]
    return t_serve.build_params(
        model, cim=True, ber=BER, protect=protect, serve_path=path,
        inject=inject, static_seeds=static, dynamic_seeds=dynamic, mesh=mesh,
        verbose=False)[0]


def _engine(olmo, params, mesh=None):
    return t_engine.Engine(olmo[2], params, n_slots=SLOTS, max_len=MAX_LEN,
                           chunk=CHUNK, collect_logits=True,
                           prefix_cache=True, mesh=mesh)


def _threads(meshes, fn):
    """``fn(mesh)`` on every rank, a thread a rank -> results in rank
    order (the first failure re-raised)."""
    out = [None] * len(meshes)

    def go(r):
        try:
            with shlib.rank_thread():
                out[r] = fn(meshes[r])
        except BaseException as e:       # re-raised below
            out[r] = e
            for m in meshes:
                m.group.abort()
    threads = [threading.Thread(target=go, args=(r,))
               for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    errors = [o for o in out if isinstance(o, BaseException)]
    if errors:
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return out


def _same(got, want, fields=EQUAL, rtol=None):
    """Per request the ``fields`` equal and the logits bitwise (within
    ``rtol`` of the largest logit's magnitude when given)."""
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        for f in fields:
            assert getattr(g, f) == getattr(w, f), (rid, f)
        if rtol is None:
            assert g.logits.tobytes() == w.logits.tobytes(), rid
        else:
            gap = np.abs(g.logits - w.logits).max()
            assert gap <= rtol * np.abs(w.logits).max(), (rid, gap)


@pytest.fixture(scope="module")
def single(olmo):
    """The port's single-device engine, arm by arm: (results, aggregate)."""
    return {arm: _engine(olmo, _params(olmo, arm)).run(_requests())
            for arm in ARMS}


@contextlib.contextmanager
def _reference_by_parts(jcfg):
    """The reference engine with its steps unjitted and their heavy parts
    jitted (``tests/test_torch_engine.py``'s method), restored on exit."""
    real = (j_lm._decode_stack, j_cim.read_rows, j_cim.store_stats,
            j_cr_ops.cim_linear_store)
    saved = dict(j_engine._STEP_CACHE)

    @functools.partial(jax.jit, static_argnums=0)
    def stack(cfg, blocks, caches, x, pos, length):
        return real[0](blocks, cfg, caches, x, pos, length=length)

    def decode_stack(params, cfg, caches, x, pos, unroll=False, length=None):
        blocks = {k: params[k] for k in ("groups", "tail", "final_norm")}
        return stack(cfg, blocks, caches, x, pos, length)
    j_lm._decode_stack = decode_stack
    j_cim.read_rows = jax.jit(real[1])
    j_cim.store_stats = jax.jit(real[2])
    j_cr_ops.cim_linear_store = jax.jit(
        functools.partial(real[3], use_kernel=False),
        static_argnames=("with_info",))
    j_engine._STEP_CACHE[jcfg, None] = (
        j_steps.make_prefill_chunk_step(jcfg),
        j_steps.make_decode_slots_step(jcfg),
        j_steps.make_extract_state_step(jcfg),
        j_steps.make_inject_state_step(jcfg))
    try:
        yield
    finally:
        (j_lm._decode_stack, j_cim.read_rows, j_cim.store_stats,
         j_cr_ops.cim_linear_store) = real
        j_engine._STEP_CACHE.clear()
        j_engine._STEP_CACHE.update(saved)


def test_dynamic_arm_matches_reference(olmo, single):
    """The reference's single-device engine on the dynamic arm: the yardstick
    the mesh runs are held to through the port's single device."""
    jcfg, params, _, dkey, _ = olmo

    def build(p, k):
        dep = j_serve.make_deployment(p, ber=BER, protect="one4n", n_group=8,
                                      index=2, key=k, inject_mode="dynamic",
                                      field="full", fault_model="")
        return dep.serving_params(**j_serve.serving_kw(
            ber=BER, key=k, inject_mode="dynamic", field="full",
            fault_model=""))
    with _reference_by_parts(jcfg):
        eng = j_engine.Engine(jcfg, jax.jit(build)(params, dkey),
                              n_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                              collect_logits=True,
                              prefix_cache=j_engine.PrefixCache())
        want = eng.run(j_engine.LoadGen(**LOAD).requests())[0]
    got, agg = single["dynamic"]
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        for f in EQUAL + ("prefix_tokens", "slot"):
            assert getattr(g, f) == getattr(w, f), (rid, f)
        np.testing.assert_allclose(g.logits, np.asarray(w.logits), rtol=RTOL,
                                   atol=ATOL)
    assert agg["prefix_hits"] >= 1 and agg["ecc"]["corrected"] > 0


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_on_1x2_equals_one_device(olmo, single, arm):
    """Stores split over "model": every rank serves the single-device
    results bitwise (the static arm's constant charges and the dynamic
    arm's per-read ones summed over the two blocks)."""
    meshes = shlib.thread_ranks(("data", "model"), (1, 2))

    def rank(m):
        params = _params(olmo, arm, m)
        if ARMS[arm][0] == "fused":
            assert params["unembed"].shard.sharded
            assert params["embed"].shard.sharded
        return _engine(olmo, params, m).run(_requests())
    for got, agg in _threads(meshes, rank):
        _same(got, single[arm][0])
        assert agg["prefix_hits"] == single[arm][1]["prefix_hits"]


def test_engine_on_2x1_splits_the_slots(olmo, single, monkeypatch):
    """Slots split over "data": each rank decodes its slot of the two, the
    logits are gathered, and every rank serves the single-device tokens and
    ECC charges (logits to rounding) and the other rank's results bitwise."""
    rows = []
    real = t_lm.LM.decode_slots

    def spy(self, caches, tokens, *a, **kw):
        rows.append(tokens.shape[0])
        return real(self, caches, tokens, *a, **kw)
    monkeypatch.setattr(t_lm.LM, "decode_slots", spy)
    meshes = shlib.thread_ranks(("data", "model"), (2, 1))
    out = _threads(meshes, lambda m: _engine(
        olmo, _params(olmo, "dynamic", m), m).run(_requests()))
    for got, _ in out:
        _same(got, single["dynamic"][0], rtol=GEMM_RTOL)
        _same(got, out[0][0])
    assert rows and set(rows) == {1}


def test_solo_prefix_and_open_loop_on_1x2(olmo, single):
    """On the 1x2 mesh: request 2 served alone equals it co-batched; a
    prefix hit's replayed charge is the summed one; an open-loop run (the
    arrivals read from rank 0's clock) gives both ranks one schedule and
    the single-device results."""
    want = single["dynamic"][0]
    meshes = shlib.thread_ranks(("data", "model"), (1, 2))

    def rank(m):
        params = _params(olmo, "dynamic", m)
        solo = _engine(olmo, params, m).run([_requests()[2]])[0]
        eng = _engine(olmo, params, m)
        reqs = _requests()
        for i, r in enumerate(reqs):     # the same requests, spread in time
            r.arrival = 0.004 * i
        timed = eng.run(reqs, open_loop=True)[0]
        return solo, timed, [(r.rid, r.slot) for r in timed.values()]
    out = _threads(meshes, rank)
    for solo, timed, sched in out:
        _same(solo, {2: want[2]})
        _same(timed, want)
        assert sched == out[0][2]
    assert any(r.prefix_tokens for r in want.values())


def test_fleet_of_two_1x1_blocks(olmo, single, tmp_path):
    """Two replicas, each on its own 1x1 block of a 2-rank world: the
    router's gathers give both ranks every result, bitwise the
    single-device engine's, each request served by one replica."""
    ranks = t_fleet.thread_fleet_meshes("1x1", 2)
    assert [fm.replica for fm in ranks] == [0, 1]
    assert ranks[0][1] is None and ranks[1][0] is None

    def rank(fm):
        params = _params(olmo, "dynamic", fm[fm.replica])
        fl = t_fleet.Fleet.from_serving_params(
            olmo[2], params, n_replicas=2, meshes=fm,
            spool_dir=str(tmp_path), n_slots=SLOTS, max_len=MAX_LEN,
            chunk=CHUNK, collect_logits=True)
        return fl.run(_requests())
    out = _threads([fm.fleet for fm in ranks],
                   lambda w: rank(ranks[w.rank]))
    for got, agg in out:
        _same(got, single["dynamic"][0], fields=("tokens", "ecc", "salt"))
        assert agg["n_requests"] == LOAD["n_requests"]
        assert sum(agg["requests_by_replica"].values()) == LOAD["n_requests"]
    assert out[0][1]["requests_by_replica"] == out[1][1]["requests_by_replica"]
    assert all(out[0][0][rid].replica == out[1][0][rid].replica
               for rid in out[0][0])


def test_rank_thread_keeps_each_threads_ambient_mesh():
    """Sixteen threads, more than the cores, each set their own ambient mesh
    and split-rows setting and read them back under a short switch
    interval; the shared settings outside stay as they were."""
    import sys
    meshes = shlib.ranks_of(("data", "model"), (4, 4))
    seen = [0] * len(meshes)
    interval = sys.getswitchinterval()

    def go(r):
        with shlib.rank_thread(), shlib.use_mesh(meshes[r]), \
                shlib.split_rows(meshes[r]):
            for _ in range(2000):
                if shlib.get_mesh() is meshes[r] and \
                        shlib.rows_mesh() is meshes[r]:
                    seen[r] += 1
    threads = [threading.Thread(target=go, args=(r,))
               for r in range(len(meshes))]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert seen == [2000] * len(meshes)
    assert shlib.get_mesh() is None and shlib.rows_mesh() is None


def test_make_fleet_meshes_refuses_a_small_world():
    try:
        with pytest.raises(ValueError, match="needs 16 ranks"):
            t_fleet.make_fleet_meshes("1x8", 2, "cpu")
    finally:
        t_mesh.destroy_world()
