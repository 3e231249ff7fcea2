"""The port's deployment surface against the JAX reference: policy matching,
the serving launcher's 2-rule policy (fused) and uniform policy (hbm), the
packed stores and injected images under the reference's own per-leaf key
split, the dynamic runtime, and the seed/salt chains."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

PLANES = ("man", "sign", "exp", "codewords")


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b").reduced()
    params = jax.jit(j_lm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("olmo-1b").reduced()
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params), cfg))
    return params, model


def _same_planes(js, ts):
    for name in PLANES:
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert np.array_equal(a.view(np.int32) if a.dtype == np.uint32
                                  else a, b.numpy()), name


def jax_store_seeds(dep, key):
    """The reference's static-injection plane seeds per store path: one key
    split over ALL flat leaves (passthrough leaves included), tree order."""
    flat, _ = dep._flat()
    keys = jax.random.split(key, len(flat))
    return {p: {k: int(v) for k, v in j_cim.plane_seeds(keys[i]).items()}
            for i, (p, leaf) in enumerate(zip(dep.paths, flat))
            if isinstance(leaf, j_cim.CIMStore)}


def test_rule_matching_and_validation():
    paths = ["embed", "unembed", "groups/blk0/attn/wq", "groups/blk0/mlp/w_in",
             "tail/0/mlp/w_out", "final_norm/scale"]
    patterns = ["embed", "unembed", "*mlp*", "groups/*/attn/*", "re:.*w_(in|out)",
                "mlp", "*", "groups/blk?/attn/w[qk]"]
    for pat in patterns:
        for p in paths:
            assert j_dep.PolicyRule(pat).matches(p) == \
                t_dep.PolicyRule(pat).matches(p), (pat, p)
    rules = [("embed", "per_weight"), ("*mlp*", "none")]
    jpol = j_dep.ReliabilityPolicy(
        rules=tuple(j_dep.PolicyRule(p, protect=x) for p, x in rules),
        default=j_dep.PolicyRule(deploy=False))
    tpol = t_dep.ReliabilityPolicy(
        rules=tuple(t_dep.PolicyRule(p, protect=x) for p, x in rules),
        default=t_dep.PolicyRule(deploy=False))
    for p in paths:
        a, b = jpol.rule_for(p), tpol.rule_for(p)
        assert (a.pattern, a.protect, a.deploy) == (b.pattern, b.protect, b.deploy)
    for bad in (dict(protect="one4N"), dict(field="exponent"),
                dict(serve_path="dram"), dict(fmt_name="fp12"),
                dict(ber_scale=-1.0)):
        with pytest.raises(ValueError):
            j_dep.PolicyRule(**bad)
        with pytest.raises(ValueError):
            t_dep.PolicyRule(**bad)
    # a rule's fault process: the grammar as the reference parses it, and
    # the same ValueError for a bad spec
    for spec in ("burst", "burst:rate=0.4,length=8,axis=bank",
                 "correlated:strength=0.6", "drift:drift_rate=0.05"):
        a = j_dep.PolicyRule(fault_model=spec).fault_process
        b = t_dep.PolicyRule(fault_model=spec).fault_process
        assert (a.kind, a.rate, a.length, a.axis, a.strength, a.period,
                a.drift_rate, a.tick) == (b.kind, b.rate, b.length, b.axis,
                                          b.strength, b.period, b.drift_rate,
                                          b.tick)
    for bad in ("nope:x=1", "burst:axis=diag"):
        with pytest.raises(ValueError):
            j_dep.PolicyRule(fault_model=bad)
        with pytest.raises(ValueError):
            t_dep.PolicyRule(fault_model=bad)


@pytest.mark.parametrize("serve_path", ["fused", "hbm"])
def test_serving_policy_deploys_identical_images(olmo, serve_path):
    params, model = olmo
    kw = dict(protect="one4n", n_group=8, index=2, serve_path=serve_path)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)

    def reference(p, key):   # deploy, inject and ECC stats, one compile
        dep = j_dep.CIMDeployment.deploy(p, j_serve.serving_policy(**kw))
        inj = dep.inject(key, 1e-3, field="full")
        return dep, inj, inj.stats()
    jdep, jinj, jst = jax.jit(reference)(params, key)
    tdep = t_dep.CIMDeployment.deploy(model.cim_leaves(),
                                      t_serve.serving_policy(**kw))
    jstores = {p: r for p, r, _ in jdep.store_leaves()}
    assert set(jstores) == {p for p, _, _ in tdep.store_leaves()} \
        == {"embed", "unembed"}
    for (jp, jr, js), (tp, tr, ts) in zip(jdep.store_leaves(),
                                          tdep.store_leaves()):
        assert jp == tp and jr.row_cache == tr.row_cache
        _same_planes(js, ts)
    assert jdep.bit_cost() == tdep.bit_cost()

    seeds = jax_store_seeds(jdep, key)
    tinj = tdep.inject(seeds, 1e-3, field="full")
    for (_, _, js), (_, _, ts) in zip(jinj.store_leaves(), tinj.store_leaves()):
        _same_planes(js, ts)
    tst = tinj.stats()
    assert (int(jst["corrected"]), int(jst["uncorrectable"])) == \
        (tst["corrected"], tst["uncorrectable"]) != (0, 0)


def test_runtime_and_seed_chains(olmo):
    params, model = olmo
    pol = dict(protect="none", n_group=8, index=2)
    tdep = t_dep.CIMDeployment.deploy(model.cim_leaves(),
                                      t_serve.serving_policy(**pol))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 1), 99)
    jrt = jax.jit(lambda p, key: j_dep.CIMDeployment.deploy(
        p, j_serve.serving_policy(**pol)).runtime(
            key, 1e-3, field="exponent_sign"))(params, key)
    base = {k: int(v) for k, v in j_cim.plane_seeds(key).items()}
    trt = tdep.runtime(base, 1e-3, field="exponent_sign")
    assert {k: int(v) for k, v in jrt["seeds"].items()} == trt["seeds"]
    assert (int(jrt["thr_man"]), int(jrt["thr_meta"])) == \
        (trt["thr_man"], trt["thr_meta"])
    for path in ("embed", "unembed", "groups/blk0/attn/wq"):
        assert j_dep.leaf_salt(path) == t_dep.leaf_salt(path)
        for rid in (None, 0, 17):
            jsalt = None if rid is None else j_dep.request_salt(rid)
            tsalt = None if rid is None else t_dep.request_salt(rid)
            assert (jsalt is None and tsalt is None) or int(jsalt) == tsalt
            for pos in (0, 8, 63):
                a = j_dep.request_read_seeds(jrt["seeds"], j_dep.leaf_salt(path),
                                             jsalt, pos)
                b = t_dep.request_read_seeds(trt["seeds"], t_dep.leaf_salt(path),
                                             tsalt, pos)
                assert {k: int(v) for k, v in a.items()} == b


def test_serving_params_and_dispatch(olmo):
    params, model = olmo
    pol = dict(protect="one4n", n_group=8, index=2)
    x = np.random.default_rng(0).standard_normal((3, 128)).astype(np.float32)

    def reference(p, x):   # deploy, serving params and dispatch, one compile
        sp = j_dep.CIMDeployment.deploy(
            p, j_serve.serving_policy(**pol)).serving_params()
        return sp["unembed"].cache, j_dep.dispatch_linear(x, sp["unembed"])
    j_cache, j_out = jax.jit(reference)(params, jnp.asarray(x))
    tdep = t_dep.CIMDeployment.deploy(model.cim_leaves(),
                                      t_serve.serving_policy(**pol))
    tsp = tdep.serving_params()
    assert tsp["embed"].cache is None and "_cim" not in tsp
    assert np.array_equal(np.asarray(j_cache).view(np.uint32),
                          tsp["unembed"].cache.numpy().view(np.uint32))
    t_out, info = t_dep.dispatch_linear(torch.from_numpy(x), tsp["unembed"],
                                        with_info=True)
    assert info["route"] == "cached"
    np.testing.assert_allclose(np.asarray(j_out), t_out.numpy(),
                               rtol=1e-5, atol=1e-5)
    dyn = tdep.serving_params(dynamic_seeds={"man": 1, "meta": 2, "cw": 3},
                              ber=1e-3)
    assert dyn["unembed"].cache is None and dyn["_cim"]["thr_man"] > 0
    out, info = tdep.linear(torch.from_numpy(x), "unembed",
                            request=(None, 5), runtime=dyn["_cim"],
                            with_info=True)
    assert info["route"] == "plain" and out.shape == (3, 256)
    hbm = t_dep.CIMDeployment.deploy(
        model.cim_leaves(), t_serve.serving_policy(serve_path="hbm", **pol))
    w, _ = hbm.read()
    out, info = hbm.linear(torch.from_numpy(x), "unembed", with_info=True)
    assert info["route"] == "hbm"
    assert torch.equal(out, torch.from_numpy(x) @ w["unembed"])
    assert dataclasses.is_dataclass(hbm.stores["unembed"])
