"""The port's continuous-batching engine against the JAX engine, and its own
contracts.

Against ``repro.launch.engine.Engine`` on reduced olmo-1b (weights through
``params_from_jax``, seeds replayed as in ``test_torch_serve.py``), one
engine per arm on the same ``LoadGen``: fused one4n static, fused one4n
dynamic, fused none dynamic, hbm, one4n dynamic under drift, and one4n
dynamic with a prefix cache over a shared 16-token prefix. Per request the
tokens, ``ecc``, ``ecc_window``, ``salt``, ``prefix_tokens``, ``slot`` and
``finish`` must be equal; logits have the same NaN pattern and, as f32
sums run in another order across frameworks, agree within
allclose(rtol=1e-4, atol=1e-5), except in the none arm, whose faulted
exponents make sums that cancel: there each logit's gap is bounded by the
magnitude of its sum, |a - b| <= 1e-4 * (|h| @ |W|) + 1e-5 with W the
read's own decoded image. ``LoadGen`` schedules and ``prefix_salt`` must
be equal.

Within the port, bitwise: a request served solo (through an engine of the
same ``n_slots``) equals it co-batched, also after the slots are reversed;
the scheduler's edges mirror ``tests/test_engine.py``. The ``gpu`` cases
hold the engine's dynamic reads on a CUDA store against the plain version
and skip without a card; they need no jax.
"""
import contextlib
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.kernels.cim_read import kernel as t_kernel  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

try:    # the reference; the card's machine runs the gpu cases without it
    import jax
    from repro.configs import get_config as j_get_config
    from repro.core import cim as j_cim
    from repro.core import deployment as j_dep
    from repro.launch import engine as j_engine
    from repro.kernels.cim_read import ops as j_cr_ops
    from repro.launch import serve as j_serve
    from repro.models import lm as j_lm
    from repro.training import steps as j_steps
    from repro_torch.convert import params_from_jax
except ImportError:
    jax = None

BER, SLOTS, CHUNK, SEED = 1e-3, 2, 8, 0
PROMPTS, GENS, PREFIX = (3, 20), (2, 5), 16
LOAD = dict(n_requests=4, prompt_lens=PROMPTS, gen_lens=GENS,
            vocab_size=256, seed=3)
# one max_len for every arm (the prefix load's): one slot-state shape, so
# every arm shares the reference's compiled block stack
MAX_LEN = PREFIX + PROMPTS[1] + GENS[1] + 1
ARMS = {   # name -> (serve_path, protect, inject, fault_model, prefix)
    "one4n_static": ("fused", "one4n", "static", "", False),
    "one4n_dynamic": ("fused", "one4n", "dynamic", "", False),
    "none_dynamic": ("fused", "none", "dynamic", "", False),
    "hbm": ("hbm", "one4n", "static", "", False),
    "one4n_drift": ("fused", "one4n", "dynamic", "drift:drift_rate=0.02",
                    False),
    "one4n_prefix": ("fused", "one4n", "dynamic", "", True),
}
# the reference's arms by params structure: arms of one structure share
# compiled reads, so they run in turn, the groups side by side
ARM_GROUPS = (("one4n_dynamic", "one4n_prefix"), ("one4n_drift",),
              ("none_dynamic",), ("one4n_static", "hbm"))
RTOL, ATOL = 1e-4, 1e-5
# The none arm's faulted exponents make weights up to 2047, so a logit can
# sit on |h| @ |W| = 4434 (rid 2, step 2, vocab 155) and cancel to far less;
# there the reference's two-row block stack rounds h so that the logit
# moves 1.8e-4 relative to its value, while no gap in the arm exceeds
# 1.1e-6 of its sum's magnitude. This arm's logits are held to the
# magnitude bound, the others' to allclose.
CANCELLING = {"none_dynamic"}
EQUAL_FIELDS = ("tokens", "ecc", "ecc_window", "salt", "prefix_tokens",
                "slot", "finish")


def _load(prefix: bool):
    return t_engine.LoadGen(**LOAD, prefix_len=PREFIX if prefix else 0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced model's tensors are tiny: one intra-op thread serves them
    faster than a pool that competes with the reference's compiler threads
    (this file's wall time halves)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the JAX reference


@pytest.fixture(scope="module")
def olmo():
    if jax is None:
        pytest.skip("needs the JAX reference package")
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(SEED)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    cfg = get_config("olmo-1b").reduced()
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return jcfg, params, model, jax.random.fold_in(key, 1)


def _reference_seeds(params, dkey, serve_path, protect):
    """Static seeds: ``plane_seeds`` of the reference's per-flat-leaf key
    split; dynamic base seeds: ``plane_seeds(fold_in(dkey, 99))``."""
    pol = j_serve.serving_policy(protect=protect, n_group=8, index=2,
                                 serve_path=serve_path)
    dep = jax.eval_shape(lambda p: j_dep.CIMDeployment.deploy(p, pol), params)
    flat, _ = dep._flat()
    keys = jax.random.split(dkey, len(flat))
    static = {p: {k: int(v) for k, v in j_cim.plane_seeds(keys[i]).items()}
              for i, (p, leaf) in enumerate(zip(dep.paths, flat))
              if isinstance(leaf, j_cim.CIMStore)}
    dynamic = {k: int(v) for k, v in
               j_cim.plane_seeds(jax.random.fold_in(dkey, 99)).items()}
    return static, dynamic


def _jax_serving_params(params, dkey, path, protect, inject, fault_model,
                        compiler_options=None):
    """The reference launcher's serving params of one arm, compiled once
    (with XLA's ``compiler_options``, if given)."""
    def build(p, k):
        if path == "hbm":
            return j_serve.deploy(p, ber=BER, protect=protect, n_group=8,
                                  index=2, key=k)[0]
        dep = j_serve.make_deployment(p, ber=BER, protect=protect, n_group=8,
                                      index=2, key=k, inject_mode=inject,
                                      field="full", fault_model=fault_model)
        return dep.serving_params(**j_serve.serving_kw(
            ber=BER, key=k, inject_mode=inject, field="full",
            fault_model=fault_model))
    return jax.jit(build, compiler_options=compiler_options)(params, dkey)


@contextlib.contextmanager
def _reference_compiled_by_parts(jcfg, compiler_options=None):
    """Run the reference engine with its steps unjitted and their heavy
    parts under ``jax.jit``: the block stack (one program for every arm,
    since no arm deploys a block weight), the row-gather read, the fused
    read (through its plain packed-jnp version, ``use_kernel=False``, the
    reference's route for stores no kernel tiles, rather than the Pallas
    kernel in interpret mode) and ``store_stats``. Each arm then compiles
    its reads once instead of once per step program, every slot's read
    included; the arithmetic is the reference's own. Everything is
    restored on exit, with the engine's step cache, so no other test sees
    a function or program traced here. ``compiler_options`` go to XLA with
    each of these programs."""
    real = (j_lm._decode_stack, j_cim.read_rows, j_cim.store_stats,
            j_cr_ops.cim_linear_store)
    saved = dict(j_engine._STEP_CACHE)

    jit = functools.partial(jax.jit, compiler_options=compiler_options)

    @functools.partial(jit, static_argnums=0)
    def stack(cfg, blocks, caches, x, pos, length):
        return real[0](blocks, cfg, caches, x, pos, length=length)

    def decode_stack(params, cfg, caches, x, pos, unroll=False, length=None):
        blocks = {k: params[k] for k in ("groups", "tail", "final_norm")}
        return stack(cfg, blocks, caches, x, pos, length)
    j_lm._decode_stack = decode_stack
    j_cim.read_rows = jit(real[1])
    j_cim.store_stats = jax.jit(real[2])    # nested in the engine's own jit
    j_cr_ops.cim_linear_store = jit(
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


@pytest.fixture(scope="module")
def reference(olmo):
    """arm -> (JAX engine's results, port engine's results, its aggregate),
    one engine per arm in each package. The reference's arms run in four
    threads, one per params structure (XLA compiles outside the GIL), the
    port's meanwhile on this thread."""
    jcfg, params, _, dkey = olmo

    def run(arms):
        out, served = {}, {}
        for arm in arms:
            path, protect, inject, fault_model, prefix = ARMS[arm]
            spec = (path, protect, inject, fault_model)
            if spec not in served:
                served[spec] = _jax_serving_params(params, dkey, *spec)
            eng = j_engine.Engine(
                jcfg, served[spec], n_slots=SLOTS, max_len=MAX_LEN,
                chunk=CHUNK, collect_logits=True,
                prefix_cache=j_engine.PrefixCache() if prefix else None)
            out[arm] = eng.run(j_engine.LoadGen(
                **LOAD, prefix_len=PREFIX if prefix else 0).requests())[0]
        return out
    with _reference_compiled_by_parts(jcfg), \
            ThreadPoolExecutor(len(ARM_GROUPS)) as ex:
        parts = [ex.submit(run, group) for group in ARM_GROUPS]
        seeds = {a[:2]: _reference_seeds(params, dkey, *a[:2])
                 for a in ARMS.values()}
        port = {arm: _port_run(olmo, arm, seeds[spec[:2]])
                for arm, spec in ARMS.items()}
        results = {}
        for part in parts:
            results.update(part.result())
    return {arm: (results[arm],) + port[arm] for arm in ARMS}


@contextlib.contextmanager
def _unembed_scales():
    """Record |h| @ |W| for every row of every unembed read the port
    makes, keyed by the bytes of the logit row it produced: the magnitude
    of each logit's sum before cancellation, which bounds its
    summation-order error. W is the read's own decoded image, read back
    through the same read (same store, seeds and position) on an identity
    probe."""
    real = t_lm._unembed_logits
    scales = {}

    def record(params, x, pos=0, req_salt=None):
        out = real(params, x, pos=pos, req_salt=req_salt)
        eye = torch.eye(x.shape[-1], dtype=x.dtype)[None]
        w = real(params, eye, pos=pos, req_salt=req_salt)[0]
        mag = x.abs() @ w.abs()
        v = out.shape[-1]
        for row, m in zip(out.reshape(-1, v), mag.reshape(-1, v)):
            scales[row.numpy().tobytes()] = m.numpy()
        return out
    t_lm._unembed_logits = record
    try:
        yield scales
    finally:
        t_lm._unembed_logits = real


def _port_run(olmo, arm, seeds):
    model = olmo[2]
    path, protect, inject, fault_model, prefix = ARMS[arm]
    static, dynamic = seeds
    sp, _, _ = t_serve.build_params(
        model, cim=True, ber=BER, protect=protect, serve_path=path,
        inject=inject, static_seeds=static, dynamic_seeds=dynamic,
        fault_model=fault_model, verbose=False)
    eng = t_engine.Engine(model, sp, n_slots=SLOTS, max_len=MAX_LEN,
                          chunk=CHUNK, collect_logits=True,
                          prefix_cache=True if prefix else None)
    with (_unembed_scales() if arm in CANCELLING
          else contextlib.nullcontext()) as scales:
        return eng.run(_load(prefix).requests()) + (scales,)


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_matches_reference(reference, arm):
    j_res, t_res, agg, scales = reference[arm]
    assert sorted(j_res) == sorted(t_res) == list(range(LOAD["n_requests"]))
    for rid, j in j_res.items():
        t = t_res[rid]
        for field in EQUAL_FIELDS:
            assert getattr(t, field) == getattr(j, field), (arm, rid, field)
        j_logits = np.asarray(j.logits)
        assert np.array_equal(np.isnan(t.logits), np.isnan(j_logits))
        if arm not in CANCELLING:
            np.testing.assert_allclose(t.logits, j_logits, rtol=RTOL,
                                       atol=ATOL)
            continue
        fin = np.isfinite(j_logits)
        assert np.array_equal(t.logits[~fin], j_logits[~fin],
                              equal_nan=True)
        mag = np.stack([scales[row.tobytes()] for row in t.logits])[fin]
        gap = np.abs(t.logits[fin] - j_logits[fin])
        assert (gap <= RTOL * mag + ATOL).all(), \
            (arm, rid, float((gap / mag).max()))
    reads = agg["ecc"]["reads"]
    if ARMS[arm][0] == "hbm":
        assert reads == 0                      # decoded once: no CIM reads
    else:
        assert reads == sum(len(r.ecc_window) for r in t_res.values()) > 0
    if ARMS[arm][4]:
        assert agg["prefix_hits"] >= 1
    # the CPU runs the plain versions: no kernel launched
    assert t_kernel.launch_counts == {"cim_read_matmul_one4n": 0,
                                      "cim_read_matmul_raw": 0}


def test_loadgen_schedules_match_reference():
    if jax is None:
        pytest.skip("needs the JAX reference package")
    for kw in (dict(rate=float("inf")), dict(rate=5.0),
               dict(rate=40.0, prefix_len=7), dict(prefix_len=PREFIX)):
        a = j_engine.LoadGen(**LOAD, **kw).requests()
        b = t_engine.LoadGen(**LOAD, **kw).requests()
        assert [(r.rid, r.tokens.tolist(), r.max_new, r.arrival) for r in a] \
            == [(r.rid, r.tokens.tolist(), r.max_new, r.arrival) for r in b]
        assert j_engine.LoadGen(**LOAD, **kw).max_len() == \
            t_engine.LoadGen(**LOAD, **kw).max_len()


def test_prefix_salt_matches_reference():
    if jax is None:
        pytest.skip("needs the JAX reference package")
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 16, 33):
        toks = rng.integers(0, 50304, n).astype(np.int32)
        assert t_dep.prefix_salt(toks) == j_dep.prefix_salt(toks), n
    assert t_dep.request_salt(5) == int(j_dep.request_salt(5))


# ------------------------------------------------------ within the port


@pytest.fixture(scope="module")
def port():
    """Reduced olmo-1b from a seeded generator, and its serving params by
    arm (the launcher's default seeds)."""
    cfg = get_config("olmo-1b").reduced()
    model = t_lm.LM(cfg, generator=torch.Generator().manual_seed(4),
                    device="cpu")
    params = {}
    for path, protect, inject in (("fused", "one4n", "static"),
                                  ("fused", "one4n", "dynamic"),
                                  ("fused", "none", "dynamic"),
                                  ("hbm", "one4n", "static")):
        params[path, protect, inject] = t_serve.build_params(
            model, cim=True, ber=BER, protect=protect, serve_path=path,
            inject=inject, verbose=False)[0]
    return model, params


def _run(model, params, reqs, *, n_slots=SLOTS, chunk=CHUNK,
         max_len=MAX_LEN, **kw):
    eng = t_engine.Engine(model, params, n_slots=n_slots, max_len=max_len,
                          chunk=chunk, collect_logits=True, **kw)
    results, agg = eng.run(reqs)
    assert sorted(results) == sorted(r.rid for r in reqs)
    return results, agg


def _requests(n=4, seed=5, plens=(3, 14), gens=(2, 4)):
    return t_engine.LoadGen(n_requests=n, prompt_lens=plens, gen_lens=gens,
                            vocab_size=256, seed=seed).requests()


@pytest.mark.parametrize("arm", [("fused", "one4n", "static"),
                                 ("fused", "one4n", "dynamic"),
                                 ("fused", "none", "dynamic"),
                                 ("hbm", "one4n", "static")])
def test_solo_equals_cobatched(port, arm):
    """Bitwise: tokens, every logit vector and the per-request ECC charges."""
    model, params = port
    reqs = _requests()
    co, _ = _run(model, params[arm], reqs)
    for rid in (0, 2):
        solo, _ = _run(model, params[arm], [r for r in reqs if r.rid == rid])
        assert co[rid].tokens == solo[rid].tokens, (arm, rid)
        assert np.array_equal(co[rid].logits, solo[rid].logits), (arm, rid)
        assert co[rid].ecc == solo[rid].ecc, (arm, rid)
        assert co[rid].ecc_window == solo[rid].ecc_window, (arm, rid)


def test_invariance_across_slot_assignment(port):
    """Reversing the arrival order moves every request to another slot and
    changes none of its tokens, logits or ECC charges."""
    model, params = port
    sp = params["fused", "one4n", "dynamic"]
    reqs = _requests()
    fwd, _ = _run(model, sp, reqs, n_slots=4)
    rev = [t_engine.Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                            arrival=float(len(reqs) - r.rid)) for r in reqs]
    bwd, _ = _run(model, sp, rev, n_slots=4)
    assert any(fwd[r.rid].slot != bwd[r.rid].slot for r in reqs)
    for r in reqs:
        assert fwd[r.rid].tokens == bwd[r.rid].tokens
        assert np.array_equal(fwd[r.rid].logits, bwd[r.rid].logits)
        assert fwd[r.rid].ecc == bwd[r.rid].ecc


def test_single_slot_matches_lock_step(port):
    """n_slots=1 on a static image against ``LM.prefill`` / ``LM.decode``:
    tokens equal; logits within allclose(rtol=1e-5, atol=1e-6), since the
    engine's chunked prefill attends over the slot's ``max_len`` rows (two
    chunks) where ``LM.prefill`` attends over the prompt alone, so its f32
    sums run over other shapes."""
    model, params = port
    sp = params["fused", "one4n", "static"]
    req = _requests(n=1, seed=9, plens=(11, 11), gens=(5, 5))[0]
    res, _ = _run(model, sp, [req], n_slots=1)
    tokens = torch.as_tensor(req.tokens, dtype=torch.int64)[None]
    logits, caches = model.prefill(tokens, sp, max_len=MAX_LEN)
    ref_tokens, ref_logits = [], []
    for _ in range(req.max_new):
        toks = logits.argmax(-1)[:, None]
        ref_tokens.append(int(toks[0, 0]))
        ref_logits.append(logits[0].numpy())
        logits, caches = model.decode(caches, toks, sp)
    assert res[req.rid].tokens == ref_tokens
    np.testing.assert_allclose(res[req.rid].logits, np.stack(ref_logits),
                               rtol=1e-5, atol=1e-6)


def test_prompt_longer_than_chunk(port):
    """A prompt split into five ragged chunks decodes the same tokens as one
    chunk (static image: no chunk enters the read chain); logits within
    allclose(rtol=1e-5, atol=1e-6) (other chunk shapes, other f32 sums)."""
    model, params = port
    sp = params["fused", "one4n", "static"]
    req = _requests(n=1, seed=11, plens=(19, 19), gens=(4, 4))[0]
    fine, _ = _run(model, sp, [req], chunk=4)       # 19 -> 4+4+4+4+3
    coarse, _ = _run(model, sp, [req], chunk=32)    # one ragged chunk
    assert fine[req.rid].tokens == coarse[req.rid].tokens
    np.testing.assert_allclose(fine[req.rid].logits, coarse[req.rid].logits,
                               rtol=1e-5, atol=1e-6)


def test_empty_queue_idle_step(port):
    model, params = port
    eng = t_engine.Engine(model, params["fused", "one4n", "static"],
                          n_slots=2, max_len=MAX_LEN, chunk=CHUNK)
    ev = eng.step()
    assert ev["idle"] and not ev["admitted"] and not ev["decoded"]
    assert eng.caches["pos_host"].tolist() == [0, 0]
    assert eng.caches["pos"].tolist() == [0, 0]
    assert eng.idle_steps == 1 and eng.steps == 0
    results, agg = eng.run([])
    assert results == {} and agg["n_requests"] == 0


def test_slot_eviction_reuse_ordering(port):
    """A finished slot frees and the next queued request takes the lowest
    free index; closed-loop admission never leaks into the latency record."""
    model, params = port
    reqs = [t_engine.Request(rid=0, tokens=np.arange(4), max_new=2),
            t_engine.Request(rid=1, tokens=np.arange(5), max_new=6),
            t_engine.Request(rid=2, tokens=np.arange(6), max_new=3)]
    res, agg = _run(model, params["fused", "one4n", "static"], reqs,
                    n_slots=2)
    assert [res[i].slot for i in range(3)] == [0, 1, 0]
    assert [len(res[i].tokens) for i in range(3)] == [2, 6, 3]
    assert all(r.finish == "length" for r in res.values())
    assert agg["total_tokens"] == 11
    for r in res.values():
        assert np.isfinite(r.queue_s) and r.queue_s >= 0 and r.finite


def test_max_len_rejection(port):
    model, params = port
    eng = t_engine.Engine(model, params["fused", "one4n", "static"],
                          n_slots=1, max_len=10, chunk=4)
    with pytest.raises(t_engine.EngineError, match="max_len"):
        eng.run([t_engine.Request(rid=0, tokens=np.arange(8), max_new=3)])


def test_max_len_boundary_write(port):
    """A request that fills its slot to exactly ``max_len``: the ragged
    tail pads only to the last row, every write stays in range, and the
    slot state refuses a write past it."""
    model, params = port
    sp = params["fused", "one4n", "dynamic"]
    req = t_engine.Request(rid=0, tokens=np.arange(13) + 7, max_new=2)
    eng = t_engine.Engine(model, sp, n_slots=2, max_len=15, chunk=8)
    seen = []
    real = eng._prefill

    def spy(params, caches, tokens, slot, pos, length, salt):
        seen.append((pos, tokens.shape[0], length))
        return real(params, caches, tokens, slot, pos, length, salt)
    eng._prefill = spy
    res, _ = eng.run([req])
    assert seen == [(0, 8, 8), (8, 7, 5)]        # padded to row 15, not 16
    assert len(res[0].tokens) == 2 and res[0].finish == "length"
    caches = t_lm.init_slot_states(model.cfg, 2, 15, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        model.prefill_chunk(caches, torch.arange(8), 1, 8, 5, 0, params=sp)
    caches["pos_host"][1] = 15
    caches["pos"][1] = 15
    with pytest.raises(ValueError, match="no row left"):
        model.decode_slots(caches, torch.zeros((2, 1), dtype=torch.int64),
                           np.array([False, True]), [0, 0], params=sp)


def test_prefix_hit_equals_cold_prefill(port):
    """A request whose leading chunks come from the trie: tokens, logits and
    ECC charges equal those of a cold engine without the cache."""
    model, params = port
    sp = params["fused", "one4n", "dynamic"]
    reqs = t_engine.LoadGen(n_requests=3, prompt_lens=(3, 10), gen_lens=(2, 3),
                            vocab_size=256, seed=2,
                            prefix_len=PREFIX).requests()
    warm, agg = _run(model, sp, reqs, prefix_cache=True)
    hit = [r for r in warm.values() if r.prefix_tokens > 0]
    assert agg["prefix_hits"] >= 1 and hit
    for r in hit:
        cold, _ = _run(model, sp, [q for q in reqs if q.rid == r.rid])
        c = cold[r.rid]
        assert c.prefix_tokens == 0
        assert r.tokens == c.tokens and r.ecc == c.ecc
        assert r.ecc_window == c.ecc_window
        assert np.array_equal(r.logits, c.logits)


def test_refresh_params_idle_only_and_invalidates(port):
    model, params = port
    sp = params["fused", "one4n", "dynamic"]
    cache = t_engine.PrefixCache()
    eng = t_engine.Engine(model, sp, n_slots=2, max_len=MAX_LEN, chunk=CHUNK,
                          prefix_cache=cache)
    eng.run(t_engine.LoadGen(n_requests=2, prompt_lens=(3, 6),
                             gen_lens=(2, 2), vocab_size=256,
                             prefix_len=PREFIX).requests())
    assert len(cache) > 0
    eng.submit(t_engine.Request(rid=9, tokens=np.arange(3), max_new=2))
    with pytest.raises(t_engine.EngineError, match="busy"):
        eng.refresh_params(sp)
    assert [r.rid for r in eng.drain()] == [9]
    eng.refresh_params(params["fused", "one4n", "static"])
    assert len(cache) == 0 and cache.invalidations == 1


def test_refresh_params_forced_mid_flight(port):
    """``force=True`` swaps a busy engine's params: in-flight requests run
    to completion on the new image from the next step on, the trie drops,
    and the per-store ECC counters carry over. Swapping in the same image
    changes nothing: tokens, logits and ECC equal an unswapped run."""
    model, params = port
    sp = params["fused", "one4n", "dynamic"]
    reqs = _requests()
    plain, _ = _run(model, sp, reqs)
    cache = t_engine.PrefixCache()
    eng = t_engine.Engine(model, sp, n_slots=SLOTS, max_len=MAX_LEN,
                          chunk=CHUNK, collect_logits=True, prefix_cache=cache)
    cache.insert(None, [1, 2], None, 0)
    swaps = []

    def swap(engine, ev):
        if engine.busy and len(swaps) < 2:
            totals = {p: dict(v) for p, v in engine.store_ecc.items()}
            engine.refresh_params(sp, force=True)
            assert engine.store_ecc == totals
            swaps.append(engine.steps)
    res, _ = eng.run(reqs, on_step=swap)
    assert len(swaps) == 2 and cache.invalidations == 2
    assert cache.lookup(None, [1, 2]) is None     # dropped by the first swap
    for r in reqs:
        a, b = plain[r.rid], res[r.rid]
        assert a.tokens == b.tokens and a.ecc == b.ecc and \
            a.ecc_window == b.ecc_window
        assert np.array_equal(a.logits, b.logits)
    eng.submit(t_engine.Request(rid=9, tokens=np.arange(3), max_new=2))
    with pytest.raises(t_engine.EngineError, match="busy"):
        eng.refresh_params(sp)


def test_check_finite_records_and_raises(port, monkeypatch):
    """Logits forced non-finite: ``check_finite=False`` serves on and
    records ``finite=False`` (the JSON artifact too); the default raises."""
    model, params = port
    sp = params["fused", "one4n", "dynamic"]     # reads one slot at a time
    real = t_lm._unembed_logits

    def poisoned(params_, x, pos=0, req_salt=None):
        out = real(params_, x, pos=pos, req_salt=req_salt)
        return out * float("nan") if req_salt == t_dep.request_salt(1) \
            else out
    monkeypatch.setattr(t_lm, "_unembed_logits", poisoned)
    reqs = _requests(n=3)
    res, agg = _run(model, sp, reqs, check_finite=False)
    assert [res[r.rid].finite for r in reqs] == [True, False, True]
    assert res[1].to_json()["finite"] is False
    assert len(res[1].tokens) == reqs[1].max_new
    with pytest.raises(t_engine.EngineError, match="non-finite"):
        _run(model, sp, reqs)


# ------------------------------------------------------ guards


def test_guards(port, monkeypatch):
    model, params = port
    cfg = model.cfg
    from repro_torch.models import moe as t_moe
    rwkv = get_config("rwkv6-1.6b").reduced()
    assert t_lm.check_engine_kinds(rwkv) == (t_lm.SLOT_STATE_SPECS["rwkv"],)
    moe = get_config("qwen3-moe-235b-a22b").reduced()
    assert t_moe.dispatch(moe) == "sort"        # a2a without a mesh
    from repro_torch.models import moe_a2a
    assert not moe_a2a.route(moe, 2, 8)         # no mesh: the dense dispatch
    # the MoE's all-to-all and the engine on a mesh have landed; the
    # scrubber on a mesh still waits
    with pytest.raises(NotImplementedError, match=r"item 14b-3"):
        t_serve.main(["--engine", "--scrub", "--reduced", "--device", "cpu",
                      "--mesh", "1x1"])
    with pytest.raises(ValueError, match="allowed"):
        t_lm.slot_state_spec("conv")
    with pytest.raises(ValueError, match="allowed"):
        t_lm.SlotStateSpec("attn", advance="sideways")
    assert t_lm.check_engine_kinds(cfg) == (t_lm.SlotStateSpec("attn"),)
    assert not t_lm.engine_capacity_coupled(cfg, SLOTS)
    caches = t_lm.init_slot_states(cfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="req_salts"):
        model.decode_slots(caches, torch.zeros((2, 1), dtype=torch.int64),
                           np.ones(2, bool),
                           params=params["fused", "one4n", "dynamic"])
    # a store on a card that is not there: the engine raises, as every CUDA
    # request does, and never serves it from the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_cim.CIMStore, "device",
                        property(lambda s: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.Engine(model, params["fused", "one4n", "dynamic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--engine", "--reduced", "--requests", "1"])


# ------------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("protect", ["one4n", "none"])
def test_engine_dynamic_reads_on_card(protect):
    """Reduced olmo-1b served by the engine on the card (K1 or K2 on every
    dynamic read, M = 1) and on the CPU (the plain versions) from the same
    weights and seeds: tokens and ECC charges equal, logits within
    allclose(1e-4, 1e-4); every read launched the kernel, inactive slots
    included."""
    dev = _cuda()
    cfg = get_config("olmo-1b").reduced()
    cpu = t_lm.LM(cfg, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    gpu = t_lm.LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    reqs = _requests(n=5, seed=6, plens=(3, 20), gens=(2, 6))
    out = {}
    for m in (cpu, gpu):
        sp = t_serve.build_params(m, cim=True, ber=BER, protect=protect,
                                  inject="dynamic", verbose=False)[0]
        t_kernel.reset_launch_counts()
        out[m.embed.device.type] = _run(m, sp, reqs)
    (c_res, _), (g_res, g_agg) = out["cpu"], out["cuda"]
    chunks = sum(-(-r.tokens.size // CHUNK) for r in reqs)
    name = "cim_read_matmul_one4n" if protect == "one4n" \
        else "cim_read_matmul_raw"
    assert t_kernel.launch_counts[name] == \
        chunks + g_agg["decode_steps"] * SLOTS
    for r in reqs:
        assert g_res[r.rid].tokens == c_res[r.rid].tokens
        assert g_res[r.rid].ecc == c_res[r.rid].ecc
        np.testing.assert_allclose(g_res[r.rid].logits, c_res[r.rid].logits,
                                   rtol=1e-4, atol=1e-4)
