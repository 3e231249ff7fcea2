"""The int8 K/V cache (``kv_cache_dtype="int8"``) against the reference's.

On reduced olmo-1b and on a local-window olmo-1b (pattern ``("local",
"attn")``, window 8), both with ``kv_cache_dtype="int8"`` and the same
weights (``params_from_jax``), the slot-state protocol runs a two-slot
prefill (chunks of 8 and 5 valid tokens) and 4 greedy decode steps in both
packages. After every step the attention layers' int8 ``k`` / ``v`` and bf16
``k_scale`` / ``v_scale`` must equal the reference's bitwise; the local
ring keeps the compute dtype there, so its float32 rows, like the logits,
agree within 1e-5 relative (f32 sums run in another order across
frameworks) and its positions exactly; the greedy tokens are equal. The
state-chunk rows that ``extract_state_chunk`` returns (values with their
scales) equal the reference's in the same way.

Within the port, bitwise: the engine serves a request solo as co-batched,
and a prefix hit as a cold prefill, on the int8 cache.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import attention as j_attn
    from repro.models import lm as j_lm
    from repro_torch.convert import params_from_jax
except ImportError:
    jax = None

SLOTS, MAX_LEN, CHUNK, STEPS = 2, 16, 8, 4
LENGTHS = (8, 5)                     # valid tokens of each slot's chunk
MODELS = ("olmo", "olmo_local")


def _cfg(get, name):
    cfg = dataclasses.replace(get("olmo-1b").reduced(), kv_cache_dtype="int8")
    if name == "olmo_local":
        cfg = dataclasses.replace(cfg, block_pattern=("local", "attn"),
                                  local_window=8)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, size=(SLOTS, CHUNK)).astype(np.int32)


def _layer_states(cfg, caches):
    """The reference's slot caches as one numpy dict a layer, in the port's
    layer order (``convert.layer_slots``)."""
    out = []
    for prefix, row in convert.layer_slots(cfg):
        if prefix.startswith("groups/"):
            st = caches["groups"][prefix.split("/")[1]]
            out.append({n: np.asarray(a[row]) for n, a in st.items()})
        else:
            st = caches["tail"][int(prefix.split("/")[1])]
            out.append({n: np.asarray(a) for n, a in st.items()})
    return out


def _same(t, j, what):
    """int8 values, bf16 scales and positions bitwise; float32 ring rows
    within 1e-5 relative."""
    if t.dtype == torch.float32:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6, err_msg=str(what))
    else:
        assert np.array_equal(_bits(t), _bits(j)), what


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _run_reference(name):
    """(per-step layer states, per-step logits, extracted chunk, params)."""
    jcfg = _cfg(j_get_config, name)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(jax.random.PRNGKey(3),
                                                     jcfg)
    pre = jax.jit(lambda p, c, t, s, l: j_lm.prefill_chunk(
        p, jcfg, c, t, s, 0, length=l))
    dec = jax.jit(lambda p, c, t: j_lm.decode_slots(
        p, jcfg, c, t, jnp.ones((SLOTS,), bool)))
    ext = jax.jit(lambda c: j_lm.extract_state_chunk(jcfg, c, 1, 0,
                                                     LENGTHS[1]))
    caches = dict(j_lm.init_slot_states(jcfg, SLOTS, MAX_LEN),
                  pos=jnp.zeros((SLOTS,), jnp.int32))
    toks = _tokens()
    states, logits, first = [], [], []
    for s in range(SLOTS):
        lg, caches = pre(params, caches, jnp.asarray(toks[s]), s, LENGTHS[s])
        first.append(np.asarray(lg))
    states.append(_layer_states(jcfg, caches))
    logits.append(np.stack(first))
    chunk = _layer_states(jcfg, ext(caches))
    cur = jnp.asarray(np.stack(first).argmax(-1)[:, None].astype(np.int32))
    for _ in range(STEPS):
        lg, caches = dec(params, caches, cur)
        states.append(_layer_states(jcfg, caches))
        logits.append(np.asarray(lg))
        cur = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    return states, logits, chunk, params


@pytest.fixture(scope="module")
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package")
    return {name: _run_reference(name) for name in MODELS}


def _port_model(name, params):
    cfg = _cfg(get_config, name)
    model = t_lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _run_port(model):
    cfg = model.cfg
    caches = t_lm.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
    toks = torch.as_tensor(_tokens(), dtype=torch.int64)
    states, logits, first = [], [], []
    snap = lambda: [{n: t.clone() for n, t in st.items()}   # noqa: E731
                    for st in caches["layers"]]
    with torch.inference_mode():
        for s in range(SLOTS):
            lg, caches = model.prefill_chunk(caches, toks[s], s, 0,
                                             LENGTHS[s])
            first.append(lg)
        states.append(snap())
        logits.append(torch.stack(first).numpy())
        chunk = t_lm.extract_state_chunk(cfg, caches, 1, 0, LENGTHS[1])
        cur = torch.stack(first).argmax(-1)[:, None]
        for _ in range(STEPS):
            lg, caches = model.decode_slots(caches, cur,
                                            np.ones(SLOTS, bool))
            states.append(snap())
            logits.append(lg.numpy())
            cur = lg.argmax(-1)[:, None]
    return states, logits, chunk


@pytest.mark.parametrize("name", MODELS)
def test_int8_cache_matches_reference(reference, name):
    """Cache values and scales bitwise at every step; the ring stays in the
    compute dtype; logits within 1e-5 relative; greedy tokens equal."""
    j_states, j_logits, _, params = reference[name]
    model = _port_model(name, params)
    t_states, t_logits, _ = _run_port(model)
    kinds = t_lm.layer_kinds(model.cfg)
    for step, (js, ts) in enumerate(zip(j_states, t_states)):
        for layer, (kind, j, t) in enumerate(zip(kinds, js, ts)):
            assert sorted(j) == sorted(t), (name, layer)
            if kind == "attn":
                assert t["k"].dtype == torch.int8
                assert t["k_scale"].dtype == torch.bfloat16
                assert t["k_scale"].shape[-1] == 1
            else:
                assert t["k"].dtype == torch.float32
            for n in t:
                _same(t[n], j[n], (name, step, layer, n))
    for jl, tl in zip(j_logits, t_logits):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
        assert np.array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("name", MODELS)
def test_state_chunk_rows_with_scales_match_reference(reference, name):
    """``extract_state_chunk``'s rows (values and their scales at the
    position axis) equal the reference's, and writing them into a fresh
    slot restores the slot."""
    _, _, j_chunk, params = reference[name]
    model = _port_model(name, params)
    cfg = model.cfg
    caches = t_lm.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
    toks = torch.as_tensor(_tokens(), dtype=torch.int64)
    with torch.inference_mode():
        for s in range(SLOTS):
            model.prefill_chunk(caches, toks[s], s, 0, LENGTHS[s])
        chunk = t_lm.extract_state_chunk(cfg, caches, 1, 0, LENGTHS[1])
        for layer, (j, t) in enumerate(zip(j_chunk, chunk["layers"])):
            for n in t:
                _same(t[n], j[n][0], (layer, n))   # the slot's batch-1 view
            if "k_scale" in t:
                assert t["k_scale"].shape == (LENGTHS[1], cfg.n_kv_heads, 1)
        fresh = t_lm.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
        t_lm.inject_state_chunk(cfg, fresh, 0, 0, chunk)
        for kind, a, b in zip(t_lm.layer_kinds(cfg), fresh["layers"],
                              caches["layers"]):
            for n in a:
                rows = slice(0, LENGTHS[1]) if kind == "attn" else slice(None)
                assert torch.equal(a[n][0, rows], b[n][1, rows]), (kind, n)


def test_quantizer_matches_reference_on_edges():
    """Ties (x / scale at k + 0.5), all-zero rows (the 1e-8 floor), the
    clip at +-127 and bf16 scale rounding, on the same float32 inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.float32(127.0) * np.arange(16) / 15 - 0.5
    x[0, 2, 0, :] = np.float32(2.5)
    x[1, 0, 1] = np.linspace(-254, 254, 16, dtype=np.float32)
    x = np.concatenate([x, x.astype(np.float32) * np.float32(1e-9)])
    if jax is None:
        pytest.skip("needs the JAX reference package")
    jq, js = j_attn._quant_kv(jnp.asarray(x))
    tq, ts = t_attn.quant_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    assert int(tq.abs().max()) == 127
    deq = t_attn.dequant_kv(tq, ts, torch.float32).numpy()
    assert np.array_equal(deq, np.asarray(j_attn._dequant_kv(jq, js,
                                                             jnp.float32)))


# ------------------------------------------------- the port's own engine


@pytest.fixture(scope="module")
def engine_params():
    cfg = _cfg(get_config, "olmo")
    model = t_lm.LM(cfg, generator=torch.Generator().manual_seed(4),
                    device="cpu")
    params = t_serve.build_params(model, cim=True, ber=1e-3,
                                  inject="dynamic", verbose=False)[0]
    return model, params


def _run(model, params, reqs, **kw):
    eng = t_engine.Engine(model, params, n_slots=2, max_len=40, chunk=8,
                          collect_logits=True, **kw)
    results, agg = eng.run(reqs)
    return results, agg


def test_engine_int8_solo_equals_cobatched(engine_params):
    model, params = engine_params
    assert model.cfg.kv_cache_dtype == "int8"
    reqs = t_engine.LoadGen(n_requests=3, prompt_lens=(3, 14), gen_lens=(2, 4),
                            vocab_size=256, seed=5).requests()
    co, _ = _run(model, params, reqs)
    for rid in (0, 2):
        solo, _ = _run(model, params, [r for r in reqs if r.rid == rid])
        assert co[rid].tokens == solo[rid].tokens, rid
        assert np.array_equal(co[rid].logits, solo[rid].logits), rid
        assert co[rid].ecc == solo[rid].ecc, rid


def test_engine_int8_prefix_hit_equals_cold(engine_params):
    model, params = engine_params
    reqs = t_engine.LoadGen(n_requests=3, prompt_lens=(3, 10), gen_lens=(2, 3),
                            vocab_size=256, seed=2, prefix_len=16).requests()
    warm, agg = _run(model, params, reqs, prefix_cache=True)
    hit = [r for r in warm.values() if r.prefix_tokens > 0]
    assert agg["prefix_hits"] >= 1 and hit
    for r in hit:
        cold, _ = _run(model, params, [q for q in reqs if q.rid == r.rid])
        assert r.tokens == cold[r.rid].tokens and r.ecc == cold[r.rid].ecc
        assert np.array_equal(r.logits, cold[r.rid].logits)
