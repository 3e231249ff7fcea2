"""End-to-end: the port's lock-step launcher serves reduced olmo-1b exactly
as the JAX launcher does, from the same weights and the same fault seeds.

Arms: fused {one4n, none} x {static, dynamic} at BER 1e-3, and hbm, and
dynamic serving under a burst and a drift fault process. Greedy
tokens must be equal; prefill logits agree within allclose(rtol=1e-4,
atol=1e-5) — f32 attention and MLP sums run in another order across
frameworks.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import MarkovLM  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

BATCH, PLEN, GEN, SEED, BER = 2, 8, 4, 0, 1e-3
ARMS = [("fused", "one4n", "static"), ("fused", "one4n", "dynamic"),
        ("fused", "none", "static"), ("fused", "none", "dynamic"),
        ("hbm", "one4n", "static")]


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b").reduced()
    key = jax.random.PRNGKey(SEED)
    params = jax.jit(j_lm.init_lm, static_argnums=1)(key, jcfg)
    cfg = get_config("olmo-1b").reduced()
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return jcfg, params, model, jax.random.fold_in(key, 1)


def _jax_serve(jcfg, params, dkey, serve_path, protect, inject,
               fault_model=""):
    """The reference launcher's lock-step loop (``repro.launch.serve._serve``)
    returning prefill logits and greedy tokens."""
    def serving_params(params, dkey):   # compiled once, not op by op
        if serve_path == "fused":
            dep = j_serve.make_deployment(params, ber=BER, protect=protect,
                                          n_group=8, index=2, key=dkey,
                                          inject_mode=inject, field="full",
                                          fault_model=fault_model)
            return dep.serving_params(**j_serve.serving_kw(
                ber=BER, key=dkey, inject_mode=inject, field="full",
                fault_model=fault_model))
        return j_serve.deploy(params, ber=BER, protect=protect, n_group=8,
                              index=2, key=dkey)[0]
    sp = jax.jit(serving_params)(params, dkey)
    prompts = JMarkovLM(jcfg.vocab_size, PLEN, BATCH, seed=SEED).batch(0)["tokens"]
    logits, caches = jax.jit(j_steps.make_prefill_step(jcfg))(sp, {"tokens": prompts})
    first = np.asarray(logits)

    def grow(a):
        if a.ndim >= 4 and a.shape[-3] == PLEN:
            pad = [(0, 0)] * a.ndim
            pad[-3] = (0, GEN)
            return jnp.pad(a, pad)
        return a
    caches = jax.tree_util.tree_map(grow, caches)
    step = jax.jit(j_steps.make_serve_step(jcfg))
    toks = jnp.argmax(logits, -1)[:, None]
    out = [toks]
    for _ in range(GEN - 1):
        logits, caches = step(sp, caches, toks)
        toks = jnp.argmax(logits, -1)[:, None]
        out.append(toks)
    return first, np.asarray(jnp.concatenate(out, axis=1))


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


def test_markov_batches_identical():
    a = JMarkovLM(256, PLEN, BATCH, seed=SEED).batch(3)["tokens"]
    b = MarkovLM(256, PLEN, BATCH, seed=SEED).batch(3)["tokens"]
    assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("serve_path,protect,inject", ARMS)
def test_serve_matches_reference(olmo, serve_path, protect, inject):
    jcfg, params, model, dkey = olmo
    j_logits, j_tokens = _jax_serve(jcfg, params, dkey, serve_path, protect,
                                    inject)
    static, dynamic = _reference_seeds(params, dkey, serve_path, protect)
    res = t_serve.serve(model, batch=BATCH, prompt_len=PLEN, gen=GEN,
                        seed=SEED, cim=True, ber=BER, protect=protect,
                        serve_path=serve_path, inject=inject,
                        static_seeds=static, dynamic_seeds=dynamic,
                        verbose=False)
    assert np.array_equal(res["tokens"], j_tokens)
    t_logits = res["prefill_logits"].numpy()
    assert np.array_equal(np.isnan(t_logits), np.isnan(j_logits))
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    assert res["launches"] == {"cim_read_matmul_one4n": 0,
                               "cim_read_matmul_raw": 0}   # CPU: plain path
    if inject == "static":
        assert res["ecc"]["corrected"] + res["ecc"]["uncorrectable"] > 0 \
            or protect == "none"


@pytest.mark.parametrize("protect,fault_model", [
    ("one4n", "burst:rate=0.25,length=4,axis=col"),
    ("none", "burst:rate=0.25,length=4,axis=col"),
    ("one4n", "drift:drift_rate=0.02")])
def test_serve_fault_model_matches_reference(olmo, protect, fault_model):
    """``--inject dynamic --fault-model``: the runtime carries the process,
    every read (the embed gather and the unembed) compiles it per element,
    drift keyed on the read position; greedy tokens equal the reference's.
    The drift reads' thresholds use the correctly rounded scale; the
    reference's float32 pow is off by an ulp at a few ticks (ROADMAP Queue
    3), which moves a threshold by a few units out of millions."""
    jcfg, params, model, dkey = olmo
    j_logits, j_tokens = _jax_serve(jcfg, params, dkey, "fused", protect,
                                    "dynamic", fault_model)
    static, dynamic = _reference_seeds(params, dkey, "fused", protect)
    res = t_serve.serve(model, batch=BATCH, prompt_len=PLEN, gen=GEN,
                        seed=SEED, cim=True, ber=BER, protect=protect,
                        serve_path="fused", inject="dynamic",
                        static_seeds=static, dynamic_seeds=dynamic,
                        fault_model=fault_model, verbose=False)
    assert np.array_equal(res["tokens"], j_tokens)
    t_logits = res["prefill_logits"].numpy()
    assert np.array_equal(np.isnan(t_logits), np.isnan(j_logits))
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    # the process changed the reads: i.i.d. serving gives other logits
    iid = t_serve.serve(model, batch=BATCH, prompt_len=PLEN, gen=GEN,
                        seed=SEED, cim=True, ber=BER, protect=protect,
                        serve_path="fused", inject="dynamic",
                        static_seeds=static, dynamic_seeds=dynamic,
                        verbose=False)
    assert not torch.equal(iid["prefill_logits"], res["prefill_logits"]) \
        or fault_model.startswith("drift")     # drift's prefill is tick 0
