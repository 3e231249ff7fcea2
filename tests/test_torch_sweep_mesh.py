"""The 2-D ``("trial", "model")`` sweep mesh against one device, the port's
and the reference's.

On a sweep mesh each Fig. 6 or policy arm column-shards every store over
``"model"``: a rank draws its block through K3 at the block's global
counters, decodes it, and the decoded columns are gathered over
``"model"`` before the eval, the ECC counts summed there; trials split over
``"trial"``. Four ranks of a 2x2 mesh run here in threads of one process
(``sharding.thread_ranks``, each thread its own ambient settings): every
rank's cells must equal the single-device port's bitwise (accuracies,
per-trial corrected and uncorrectable counts), and the reference's
single-device ``SweepEngine`` (counts and stored bits bitwise; Fig. 6
accuracies within 1/N_eval, the tolerance of ``tests/test_torch_sweep.py``,
whose reasons hold here; policy accuracies bitwise, as in
``tests/test_torch_codesign.py``). Each reference result is computed once.
"""
import functools
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.losses import lm_loss as j_lm_loss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.losses import lm_loss  # noqa: E402

O0 = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=O0)
BERS, N_TRIALS = (1e-3, 1e-2), 2
PROTECTS = ("none", "one4n")
CIM_CFG = dict(n_group=8, index=2)
LM_BATCH, LM_SEQ = 2, 16
MESH = (("trial", "model"), (2, 2))


class _O0Jax(types.ModuleType):
    """``jax`` as the reference's sweep module sees it, its ``jit`` at O0
    (``tests/test_torch_sweep.py``: at the default level XLA contracts
    alignment's rescale into an FMA and a weight rounds differently)."""
    jit = staticmethod(jit)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    saved = (j_sweep.jax, j_cim.deploy_pytree_impl)
    j_sweep.jax = _O0Jax("jax")
    j_cim.deploy_pytree_impl = lambda params, cfg: jit(functools.partial(
        saved[1], cfg=cfg))(params)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    j_sweep.jax, j_cim.deploy_pytree_impl = saved


def _on_mesh(fn):
    """``fn(mesh)`` on every rank of a 2x2 ``("trial", "model")`` mesh, a
    thread a rank -> the ranks' results in rank order."""
    meshes = shlib.thread_ranks(*MESH, timeout=120.0)
    out = [None] * len(meshes)

    def go(r):
        try:
            with shlib.rank_thread():
                out[r] = fn(meshes[r])
        except BaseException as e:       # re-raised below
            out[r] = e
            meshes[0].group.abort()
    threads = [threading.Thread(target=go, args=(r,))
               for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    for o in out:
        if isinstance(o, BaseException):
            raise o
    return out


def _cells(res):
    return [(c.ber, c.field, c.protect, c.accuracies, c.trial_corrected,
             c.trial_uncorrectable, c.stored_bits) for c in res]


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b").reduced()
    jp = jit(j_lm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    flat = convert.flat_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    model = t_lm.LM(get_config("olmo-1b").reduced(), device="cpu")
    toks = JMarkovLM(jcfg.vocab_size, LM_SEQ, LM_BATCH, seed=0).batch(0)[
        "tokens"]
    clean = jnp.argmax(jit(lambda p, t: j_lm.forward(
        p, jcfg, {"tokens": t}, remat=False)[0])(jp, toks), -1)
    t_toks = torch.from_numpy(np.array(toks)).long()
    t_labels = torch.from_numpy(np.array(clean)).long()

    def j_eval(p):
        logits, _, _ = j_lm.forward(p, jcfg, {"tokens": toks}, remat=False)
        return j_lm_loss(logits, clean)[1]["accuracy"]

    def t_eval(p):
        return lm_loss(t_lm.forward(model, p, t_toks), t_labels)[1][
            "accuracy"]
    return jp, flat, j_eval, t_eval


def test_sweep_mesh_protection_cells(olmo):
    """Fig. 6 arms (none, one4n) on a 2x2 sweep mesh: every rank's cells
    equal the single-device port's and the reference's."""
    jp, flat, j_eval, t_eval = olmo
    key = jax.random.PRNGKey(5)
    j_res = j_sweep.SweepEngine(j_sweep.SweepPlan(
        bers=BERS, n_trials=N_TRIALS, protects=PROTECTS, backend="pallas",
        interpret=True, shard_trials=False)).run_protection(
            key, jp, j_eval, j_cim.CIMConfig(**CIM_CFG))
    seeds, k = [], key
    for _ in PROTECTS:
        k, sub = jax.random.split(k)
        seeds.append(np.asarray(jax.random.bits(sub, (len(BERS), N_TRIALS),
                                                jnp.uint32)))
    seeds = np.stack(seeds)
    plan = t_sweep.SweepPlan(bers=BERS, n_trials=N_TRIALS, protects=PROTECTS)
    cfg = t_cim.CIMConfig(**CIM_CFG)
    one = t_sweep.SweepEngine(plan, device="cpu").run_protection(
        seeds, flat, t_eval, cfg)
    ranks = _on_mesh(lambda m: t_sweep.SweepEngine(
        plan, device="cpu", mesh=m).run_protection(seeds, flat, t_eval, cfg))
    for got in ranks:
        assert _cells(got) == _cells(one)
    assert one[-1].corrected > 0
    n_eval = LM_BATCH * LM_SEQ
    for a, b in zip(j_res, one):
        assert (a.ber, a.field, a.protect) == (b.ber, b.field, b.protect)
        assert (a.corrected, a.uncorrectable) == \
            (b.corrected, b.uncorrectable)
        assert np.all(np.abs(np.asarray(a.accuracies)
                             - np.asarray(b.accuracies))
                      <= 1.0 / n_eval + 1e-9)
    # the stores really split: embed and unembed are column blocks
    eng = t_sweep.SweepEngine(plan, device="cpu",
                              mesh=shlib.VirtualMesh(*MESH, (1, 1)))
    stores, _ = t_cim.deploy_pytree_impl(flat, cfg)
    placed = eng._shard_stores(stores)
    for path in ("embed", "unembed"):
        sh = placed[path].shard
        assert sh.sharded and sh.index == 1 and sh.dim == "j"
        assert placed[path].man.shape[1] * 2 == stores[path].man.shape[1]


def _policy_fixture():
    """Two 64x64 leaves, only "a" read by the eval (the reference's
    ``_search_fixture`` shape, ``tests/test_torch_codesign.py``)."""
    rng = np.random.default_rng(0)
    mag = rng.uniform(0.5, 1.0, (64, 64))
    sign = np.where(rng.random((64, 64)) < 0.5, 1.0, -1.0)
    a0 = (mag * sign).astype(np.float16).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    tol = (np.float32(0.6) * np.abs(a0) + np.float32(1e-3)).astype(np.float32)
    jp = {"a": jnp.asarray(a0), "b": jnp.asarray(b)}
    tp = {"a": torch.from_numpy(a0.copy()), "b": torch.from_numpy(b.copy())}
    ta0, ttol = torch.from_numpy(a0), torch.from_numpy(tol)

    def j_eval(p):
        return jnp.mean((jnp.abs(p["a"] - a0) < tol).astype(jnp.float32))

    def t_eval(p):
        return ((p["a"] - ta0).abs() < ttol).to(torch.float32).mean()
    return jp, tp, j_eval, t_eval


def _arms(dep_mod):
    R, P = dep_mod.PolicyRule, dep_mod.ReliabilityPolicy
    return {"mixed": P(rules=(R("a", protect="one4n", field="exponent_sign",
                                ber_scale=0.3),
                              R("b", protect="none", ber_scale=2.5))),
            "pw": P(rules=(), default=R(protect="per_weight"))}


def test_sweep_mesh_policy_cells():
    """Policy arms (a mixed one4n / none arm, a per-weight arm whose
    codeword plane splits too) on a 2x2 sweep mesh, at the reference's
    plane seeds: every rank's cells equal the single-device port's and the
    reference's, bitwise."""
    jp, tp, j_eval, t_eval = _policy_fixture()
    ber = 3e-3
    key = jax.random.PRNGKey(11)
    j_arms, t_arms = _arms(j_dep), _arms(t_dep)
    j_res = j_sweep.SweepEngine(j_sweep.SweepPlan(
        bers=(ber,), n_trials=N_TRIALS, shard_trials=False)).run_policies(
            key, jp, j_eval, j_arms)
    seeds, k = [], key
    for _ in j_arms:
        k, subs = j_sweep._split_schedule(k, N_TRIALS)
        trials = []
        for t in range(N_TRIALS):
            leaf_keys = jax.random.split(subs[t], len(tp))
            trials.append({p: {n: int(v) for n, v in j_cim.plane_seeds(
                leaf_keys[i]).items()} for i, p in enumerate(tp)})
        seeds.append([trials])
    plan = t_sweep.SweepPlan(bers=(ber,), n_trials=N_TRIALS)
    one = t_sweep.SweepEngine(plan, device="cpu").run_policies(
        seeds, tp, t_eval, t_arms)
    ranks = _on_mesh(lambda m: t_sweep.SweepEngine(
        plan, device="cpu", mesh=m).run_policies(seeds, tp, t_eval, t_arms))
    for got in ranks:
        assert _cells(got) == _cells(one)
    assert one[0].corrected > 0 and min(one[0].accuracies) < 1.0
    for a, b in zip(j_res, one):
        assert (a.ber, a.field, a.protect) == (b.ber, b.field, b.protect)
        assert a.accuracies == b.accuracies, a.protect
        assert (a.corrected, a.uncorrectable, a.stored_bits) == \
            (b.corrected, b.uncorrectable, b.stored_bits), a.protect


def test_sweep_and_production_mesh_refusals():
    """Both builders follow ``mesh._mesh``: a mesh the world does not match
    raises, as does a model axis that does not divide the ranks; a 1x1
    sweep mesh has both axes."""
    try:
        mesh = t_mesh.make_sweep_mesh(1, device_type="cpu")
        assert shlib.axis_names(mesh) == ("trial", "model")
        with pytest.raises(ValueError, match="does not divide"):
            t_mesh.make_sweep_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            t_mesh.make_sweep_mesh(2, n_devices=4, device_type="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            t_mesh.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            t_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        t_mesh.destroy_world()
