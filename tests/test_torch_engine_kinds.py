"""The port's continuous-batching engine over every block kind: ``attn``,
``local`` (a rolling ring), ``rwkv`` and ``rec`` (recurrent folds with
inactive-slot freezing) and drop-free ``moe``.

Within the port, bitwise (``tests/test_engine.py``'s scenario matrix): for
each kind under static and per-read dynamic injection, a request's tokens,
logits and ECC charges are the same served alone (through an engine of the
same ``n_slots``) or co-batched, with no capacity warning; a prefix-cache
hit, which injects a ``'state'`` kind's post-chunk snapshot, equals a cold
prefill; an idle slot's fold state does not move while others decode.

Against ``repro.launch.engine.Engine``: rwkv6-1.6b (reduced) served by
both engines from one set of weights and the reference's seeds (fused
one4n, dynamic), its steps run as ``tests/test_torch_engine.py`` runs them
(unjitted, the block stack and the reads under ``jax.jit``): tokens, ECC
charges and salts equal; each logit within 1e-4 of the magnitude of its
sum, |a - b| <= 1e-4 * (|h| @ |W|) + 1e-5 with W the read's own decoded
image (``tests/test_torch_engine.py``'s bound: at BER 1e-3 the dynamic
reads leave uncorrectable words whose weights dwarf the rest, so some
logits are large and differ by up to 1e-2 in value, while no gap exceeds
2e-5 of its sum's magnitude).
The other kinds are held to the reference at the model level
(``tests/test_torch_kinds.py``), as ROADMAP's rules have a full reference
engine run for one kind only.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import engine as t_engine  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

BER, SLOTS, CHUNK, MAX_LEN = 1e-3, 4, 8, 24
KINDS = ("attn", "local", "rwkv", "rec", "moe")


def _kind_cfg(kind):
    olmo = get_config("olmo-1b").reduced()
    return {"attn": olmo,
            # a window below max_len, so the ring wraps and evicts
            "local": dataclasses.replace(olmo, block_pattern=("local",),
                                         local_window=CHUNK),
            "rwkv": get_config("rwkv6-1.6b").reduced(),
            "rec": dataclasses.replace(
                get_config("recurrentgemma-9b").reduced(), n_layers=5),
            "moe": get_config("qwen3-moe-235b-a22b").reduced()}[kind]


_MODELS = {}


def _model(kind):
    if kind not in _MODELS:
        _MODELS[kind] = t_lm.LM(_kind_cfg(kind),
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    return _MODELS[kind]


def _params(kind, inject):
    return t_serve.build_params(_model(kind), cim=True, ber=BER,
                                inject=inject, verbose=False)[0]


def _requests(n=3, seed=5, plens=(3, 14), gens=(3, 5), prefix=0):
    return t_engine.LoadGen(n_requests=n, prompt_lens=plens, gen_lens=gens,
                            vocab_size=256, seed=seed,
                            prefix_len=prefix).requests()


def _run(model, params, reqs, **kw):
    kw = {"n_slots": SLOTS, "max_len": MAX_LEN, "chunk": CHUNK,
          "collect_logits": True, **kw}
    with torch.inference_mode():
        return t_engine.Engine(model, params, **kw).run(reqs)


def _same(a, b) -> bool:
    return a.tokens == b.tokens and a.ecc == b.ecc and \
        np.array_equal(a.logits, b.logits)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("inject", ["static", "dynamic"])
def test_scenario_matrix_batch_invariance(kind, inject):
    """Each kind, static and dynamic: rids 0 and 2 served solo equal them
    co-batched, bitwise (tokens, logits, ECC); no capacity warning (MoE is
    drop-free at 4 slots and 8-token chunks); every logit finite."""
    model, params = _model(kind), _params(kind, inject)
    reqs = _requests()
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no capacity-coupling warning
        eng = t_engine.Engine(model, params, n_slots=SLOTS, max_len=MAX_LEN,
                              chunk=CHUNK, collect_logits=True)
    assert eng.capacity_coupled is False
    with torch.inference_mode():
        co, _ = eng.run(reqs)
    assert sorted(co) == [r.rid for r in reqs]
    for rid in (0, 2):
        solo, _ = _run(model, params, [reqs[rid]])
        assert _same(co[rid], solo[rid]), (kind, inject, rid)
        assert np.isfinite(co[rid].logits).all()


@pytest.mark.parametrize("kind", ["local", "rwkv", "rec"])
def test_prefix_hit_equals_cold_prefill_for_state_kinds(kind):
    """A shared 16-token prefix through a prefix cache: the ``'state'``
    kinds cache the post-chunk snapshot (ring, fold), and every request,
    hit or not, equals its cold prefill through an engine without a
    cache, bitwise, dynamic injection included."""
    model, params = _model(kind), _params(kind, "dynamic")
    reqs = _requests(n=4, plens=(3, 6), gens=(2, 3), prefix=16)
    max_len = 16 + 6 + 3 + 1
    warm, agg = _run(model, params, reqs, max_len=max_len, prefix_cache=True)
    cold, _ = _run(model, params, reqs, max_len=max_len)
    assert agg["prefix_hits"] >= 3
    assert all(r.prefix_tokens == 16 for r in list(warm.values())[1:])
    for r in reqs:
        assert _same(warm[r.rid], cold[r.rid]), (kind, r.rid)


@pytest.mark.parametrize("kind", ["rwkv", "rec"])
def test_idle_slot_keeps_its_fold_state(kind):
    """A slot freed by an evicted request keeps its fold state untouched
    while the other slots decode (its garbage token never advances the
    fold), and the next request admitted into it starts from zero: its
    tokens equal a fresh engine's."""
    model, params = _model(kind), _params(kind, "static")
    reqs = _requests(n=3, seed=8, plens=(4, 6), gens=(2, 2))
    reqs[1].max_new = 8                          # keeps slot 1 busy
    reqs[2].arrival = 1e9                        # admitted late, by hand
    eng = t_engine.Engine(model, params, n_slots=2, max_len=MAX_LEN,
                          chunk=CHUNK, collect_logits=True)
    fold = [i for i, k in enumerate(t_lm.layer_kinds(model.cfg))
            if t_lm.slot_state_spec(k).fold_state]
    with torch.inference_mode():
        eng.submit(reqs[0], 0.0)
        eng.submit(reqs[1], 0.0)
        eng._t0 = 0.0
        while 0 not in eng.results:
            eng.step(now=0.0)
        assert eng.slots[0] is None and eng.results[0].slot == 0
        frozen = [{n: t[0].clone() for n, t in eng.caches["layers"][i]
                   .items()} for i in fold]
        assert any(t.any() for s in frozen for t in s.values())
        for _ in range(3):
            ev = eng.step(now=0.0)
            assert ev["decoded"] == [1]
        for i, snap in zip(fold, frozen):
            for n, t in snap.items():
                assert torch.equal(eng.caches["layers"][i][n][0], t), (i, n)
        eng.submit(reqs[2], 0.0)
        while eng.busy:
            eng.step(now=float("inf"))
    fresh, _ = _run(model, params, [reqs[2]], n_slots=2)
    assert eng.results[2].slot == 0
    assert _same(eng.results[2], fresh[2])


def test_window_clamps_the_chunk_and_capacity_coupling_warns():
    """A ``window_bound`` kind clamps the prefill chunk to its window; a MoE
    engine whose shape is not drop-free (16-token chunks at 4 experts of
    capacity 10) warns that the bitwise guarantee is void, as the
    reference's engine does."""
    local = _model("local")
    eng = t_engine.Engine(local, None, n_slots=2, max_len=MAX_LEN, chunk=16)
    assert eng.chunk == CHUNK and not eng.capacity_coupled
    moe = _model("moe")
    with pytest.warns(UserWarning, match="capacity-coupled"):
        eng = t_engine.Engine(moe, None, n_slots=4, max_len=MAX_LEN,
                              chunk=16)
    assert eng.capacity_coupled


# ------------------------------------------------------ the JAX reference


def test_rwkv_engine_matches_reference():
    jax = pytest.importorskip("jax")
    from test_torch_engine import (_jax_serving_params,
                                   _reference_compiled_by_parts,
                                   _reference_seeds, _unembed_scales)
    from test_torch_kinds import O0, reference
    from repro.launch import engine as j_engine
    r = reference("rwkv6-1.6b")
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    load = dict(n_requests=3, prompt_lens=(3, 20), gen_lens=(2, 4),
                vocab_size=256, seed=3)
    max_len = 20 + 4 + 1
    with _reference_compiled_by_parts(r.jcfg, O0):
        served = _jax_serving_params(r.jp, key, "fused", "one4n", "dynamic",
                                     "", O0)
        eng = j_engine.Engine(r.jcfg, served, n_slots=2, max_len=max_len,
                              chunk=CHUNK, collect_logits=True)
        j_res = eng.run(j_engine.LoadGen(**load).requests())[0]
    static, dynamic = _reference_seeds(r.jp, key, "fused", "one4n")
    sp, _, _ = t_serve.build_params(
        r.model, cim=True, ber=BER, protect="one4n", inject="dynamic",
        static_seeds=static, dynamic_seeds=dynamic, verbose=False)
    with _unembed_scales() as scales:
        t_res, _ = _run(r.model, sp, t_engine.LoadGen(**load).requests(),
                        n_slots=2, max_len=max_len)
    assert sorted(j_res) == sorted(t_res) == [0, 1, 2]
    for rid, j in j_res.items():
        t = t_res[rid]
        for field in ("tokens", "ecc", "ecc_window", "salt", "slot",
                      "finish"):
            assert getattr(t, field) == getattr(j, field), (rid, field)
        mag = np.stack([scales[row.tobytes()] for row in t.logits])
        gap = np.abs(t.logits - np.asarray(j.logits))
        assert (gap <= 1e-4 * mag + 1e-5).all(), \
            (rid, float((gap / mag).max()))
