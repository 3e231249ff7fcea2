"""The port's characterization sweeps (Fig. 2 fields, Fig. 6 protection)
against the JAX reference engine under ``backend="pallas"`` (its Pallas
kernel in interpret mode), on the CNN and on reduced olmo-1b.

Both sides get the same weights and the same trial seeds, drawn by the live
``jax.random`` in the order the reference's ``_trial_randomness`` consumes
keys. Integer state must match bit for bit: every faulted leaf per (BER,
trial), every batched store plane, every ECC count. Accuracies agree within
1/N_eval per cell: a prediction can differ where two logits are within fp32
summation-order error of each other, or where a logit overflows to inf in
one framework's summation order and not in the other's. NaN logits are
otherwise the same on both sides (the faulted weights are bitwise equal),
and both argmaxes then pick the first NaN. Logits agree within
allclose(rtol=1e-4, atol=1e-5), as in ``tests/test_torch_serve.py``.

The reference's programs compile at XLA's backend optimisation level 0
(``tests/test_torch_kinds.py``'s ``O0``), and each reference result is
computed once: the faulted leaves and batched stores the checks hold the
port's to are the ones the reference engine drew inside its own planes
(recorded by a ``jax.debug.callback``), and the engine's deployment is
the one the plane checks deploy.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.data.synthetic import GaussianBlobs as JGaussianBlobs  # noqa: E402
from repro.data.synthetic import MarkovLM as JMarkovLM  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.losses import lm_loss as j_lm_loss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import resilience as t_res  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core import tree as t_tree  # noqa: E402
from repro_torch.data.synthetic import GaussianBlobs  # noqa: E402
from repro_torch.kernels.fault_inject import kernel as t_fi_kernel  # noqa: E402
from repro_torch.kernels.fault_inject import ops as t_fi_ops  # noqa: E402
from repro_torch.models import cnn as t_cnn  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.losses import lm_loss  # noqa: E402

# XLA options of the reference's programs (tests/test_torch_kinds.py's): each
# compiles once on toy shapes, where LLVM's passes cost more than they save
O0 = {"xla_backend_optimization_level": 0}
jit = functools.partial(jax.jit, compiler_options=O0)


class _O0Jax(types.ModuleType):
    """``jax`` as the reference's sweep module sees it, its ``jit`` at O0."""
    jit = staticmethod(jit)

    def __getattr__(self, name):
        return getattr(jax, name)


# The faulted leaves / batched stores the reference engine drew, recorded
# from inside its own compiled planes: (field or None, seeds) -> {path:
# array}. The plane checks below read these rather than lower the
# reference's injection (its kernel in interpret mode) a second time.
DRAWN = {}


def _recording(inject, field_arg: bool):
    def wrapped(tree_, seeds, threshold, *args, **kw):
        out = inject(tree_, seeds, threshold, *args, **kw)
        field = args[0] if field_arg else None

        def record(seeds_, leaves):
            DRAWN[(field, tuple(np.asarray(seeds_).tolist()))] = leaves
        jax.debug.callback(record, seeds, _jax_flat(out))
        return out
    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _reference_at_o0():
    """The reference sweep's programs at O0, its injections recorded
    (``DRAWN``), and each of its deployments made once, jitted at O0: its
    engine and the plane checks below deploy the same (params, config)
    pair, so the second call takes the first's stores. (Under ``jax.jit``
    at the default level XLA contracts alignment's rescale into an FMA
    and a weight rounds to the neighbouring fp16 value; at level 0 it
    does not, and the port's planes are held to these bitwise.)"""
    saved = (j_sweep.jax, j_cim.deploy_pytree_impl,
             j_sweep.inject_pytree_batched, j_sweep.cim_inject_pytree_batched)
    deployed = {}

    def deploy_once(params, cfg):
        key = (id(params), cfg)
        if key not in deployed:
            deployed[key] = (params, jit(functools.partial(
                saved[1], cfg=cfg))(params))
        return deployed[key][1]
    j_sweep.jax = _O0Jax("jax")
    j_cim.deploy_pytree_impl = deploy_once
    j_sweep.inject_pytree_batched = _recording(saved[2], True)
    j_sweep.cim_inject_pytree_batched = _recording(saved[3], False)
    yield
    (j_sweep.jax, j_cim.deploy_pytree_impl, j_sweep.inject_pytree_batched,
     j_sweep.cim_inject_pytree_batched) = saved
    DRAWN.clear()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the workers of a parallel test run share the
    cores, and torch's thread pool on small tensors then spends more time
    waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("sign", "exponent", "mantissa", "full")
PROTECTS = ("none", "per_weight", "one4n")
CIM_CFG = dict(n_group=8, index=2)
N_CNN = 256
LM_BATCH, LM_SEQ = 2, 16


def _arm_seeds(key, n_arms, n_bers, n_trials):
    """The reference engine's pallas-route trial seeds, arm by arm."""
    out = []
    for _ in range(n_arms):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.bits(sub, (n_bers, n_trials),
                                              jnp.uint32)))
    return np.stack(out)


def _j_engine(**plan):
    return j_sweep.SweepEngine(j_sweep.SweepPlan(
        backend="pallas", interpret=True, shard_trials=False, **plan))


def _assert_close_cells(j_res, t_res, n_eval):
    assert len(j_res) == len(t_res)
    for a, b in zip(j_res, t_res):
        assert (a.ber, a.field, a.protect) == (b.ber, b.field, b.protect)
        assert np.all(np.abs(np.asarray(a.accuracies)
                             - np.asarray(b.accuracies)) <= 1.0 / n_eval + 1e-9)
        assert (a.corrected, a.uncorrectable) == (b.corrected, b.uncorrectable)


def _jax_flat(tree):
    """``{path: leaf}`` in jax's own flatten order, paths joined by '/'."""
    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(name(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_bits(j_arr, t_arr):
    a = np.asarray(j_arr)
    b = t_arr.detach().contiguous().numpy()
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


@pytest.fixture(scope="module")
def cnn():
    """The CNN (16 classes), its eval batch and the reference's clean
    logits, each computed once."""
    jp = jit(j_cnn.init_cnn, static_argnames="n_classes")(
        jax.random.PRNGKey(0), n_classes=16)
    tp = convert.cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x, y = JGaussianBlobs().batch(N_CNN, 99_999)
    xt, yt = (torch.from_numpy(a) for a in GaussianBlobs().batch(N_CNN, 99_999))

    def j_eval(p):
        return jnp.mean(jnp.argmax(j_cnn.apply_cnn(p, x), -1) == y)

    def t_eval(p):
        return (t_cnn.apply_cnn(p, xt).argmax(-1) == yt).to(torch.float32).mean()
    logits = np.asarray(jit(j_cnn.apply_cnn)(jp, x))
    return jp, tp, j_eval, t_eval, (x, xt, logits)


@pytest.fixture(scope="module")
def olmo():
    """Reduced olmo-1b; the eval labels are the clean model's greedy
    predictions, so accuracy is agreement with the clean model."""
    jcfg = j_get_config("olmo-1b").reduced()
    jp = jit(j_lm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    flat = convert.flat_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    model = t_lm.LM(get_config("olmo-1b").reduced(), device="cpu")
    toks = JMarkovLM(jcfg.vocab_size, LM_SEQ, LM_BATCH, seed=0).batch(0)["tokens"]
    logits = jit(lambda p, t: j_lm.forward(p, jcfg, {"tokens": t},
                                           remat=False)[0])(jp, toks)
    clean = jnp.argmax(logits, -1)
    batch = {"tokens": toks, "labels": clean, "logits": np.asarray(logits)}
    t_toks = torch.from_numpy(np.array(toks)).long()
    t_labels = torch.from_numpy(np.array(clean)).long()

    def j_eval(p):
        logits, _, _ = j_lm.forward(p, jcfg, {"tokens": toks}, remat=False)
        return j_lm_loss(logits, clean)[1]["accuracy"]

    def t_eval(p):
        return lm_loss(t_lm.forward(model, p, t_toks), t_labels)[1]["accuracy"]
    return jcfg, jp, flat, model, j_eval, t_eval, batch


def test_gaussian_blobs_batches_identical():
    for step in (0, 7):
        jx, jy = JGaussianBlobs().batch(33, step)
        tx, ty = GaussianBlobs().batch(33, step)
        assert np.array_equal(np.asarray(jx).view(np.uint32), tx.view(np.uint32))
        assert np.array_equal(np.asarray(jy), ty)


def test_apply_cnn_matches_reference(cnn):
    jp, tp, _, _, (x, xt, want) = cnn
    got = t_cnn.apply_cnn(tp, xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert t_cnn.accuracy(tp, xt, xt.new_zeros(N_CNN).long()) == \
        pytest.approx(float(np.mean(got.argmax(-1) == 0)))


def test_lm_forward_and_loss_match_reference(olmo):
    jcfg, jp, flat, model, j_eval, t_eval, batch = olmo
    want = batch["logits"]
    toks = torch.from_numpy(np.array(batch["tokens"])).long()
    got = t_lm.forward(model, flat, toks)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    labels = np.asarray(batch["labels"]).copy()
    labels[0, :3] = -100                              # IGNORE positions
    j_loss, j_m = jit(j_lm_loss)(want, labels)
    t_loss, t_m = lm_loss(got, torch.from_numpy(labels).long())
    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(t_m["accuracy"]) == float(j_m["accuracy"])
    assert int(t_m["tokens"]) == int(j_m["tokens"])
    assert float(t_eval(flat)) == 1.0 == float(jit(j_eval)(jp))


def _fields_parity(jp, tp, j_eval, t_eval, n_eval, bers, n_trials, fields):
    key = jax.random.PRNGKey(3)
    j_res = _j_engine(bers=bers, n_trials=n_trials, fields=fields) \
        .run_fields(key, jp, j_eval)
    seeds = _arm_seeds(key, len(fields), len(bers), n_trials)
    t_fi_kernel.reset_launch_counts()
    t_res_ = t_res.characterize_fields(seeds, tp, t_eval, bers, fields=fields,
                                       n_trials=n_trials, device="cpu")
    assert t_fi_kernel.launch_counts[t_fi_kernel.K3] == 0   # CPU: plain
    _assert_close_cells(j_res, t_res_, n_eval)
    # every faulted leaf of every (arm, BER, trial), bit for bit, against
    # the leaves the reference engine drew
    for a, field in enumerate(fields):
        for b, ber in enumerate(bers):
            want = DRAWN[(field, tuple(seeds[a, b].tolist()))]
            got = t_sweep.inject_pytree_batched(
                tp, seeds[a, b], t_fi_ops.ber_to_threshold(ber), field)
            assert list(want) == list(got)             # the same leaf order
            for path in got:
                assert _same_bits(want[path], got[path]), (field, ber, path)
    return t_res_


def test_run_fields_on_cnn(cnn):
    jp, tp, j_eval, t_eval, _ = cnn
    res = _fields_parity(jp, tp, j_eval, t_eval, N_CNN, (1e-4, 1e-2), 3,
                         FIELDS)
    assert len(res) == len(FIELDS) * 2 and all(len(r.accuracies) == 3
                                               for r in res)


def test_run_fields_on_reduced_olmo(olmo):
    _, jp, flat, _, j_eval, t_eval, _ = olmo
    res = _fields_parity(jp, flat, j_eval, t_eval, LM_BATCH * LM_SEQ,
                         (1e-3, 3e-2), 2, ("exponent", "full"))
    by = {(r.field, r.ber): r.mean for r in res}
    assert by[("exponent", 3e-2)] < 1.0          # faults land


@pytest.mark.parametrize("protect", PROTECTS)
def test_run_protection_on_reduced_olmo(olmo, protect):
    _, jp, flat, _, j_eval, t_eval, _ = olmo
    bers, n_trials = (1e-3, 1e-2), 2
    key = jax.random.PRNGKey(5)
    j_cfg = j_cim.CIMConfig(protect=protect, **CIM_CFG)
    t_cfg = t_cim.CIMConfig(protect=protect, **CIM_CFG)
    j_res = _j_engine(bers=bers, n_trials=n_trials, protects=(protect,)) \
        .run_protection(key, jp, j_eval, j_cfg)
    seeds = _arm_seeds(key, 1, len(bers), n_trials)
    t_res_ = t_res.characterize_protection(
        seeds, flat, t_eval, bers, cim_cfg=t_cfg, n_trials=n_trials,
        protects=(protect,), device="cpu")
    _assert_close_cells(j_res, t_res_, LM_BATCH * LM_SEQ)
    if protect != "none":
        assert t_res_[-1].corrected > 0
    # the batched stores of every BER, plane by plane, against the ones the
    # reference engine drew
    t_stores, _ = t_cim.deploy_pytree_impl(flat, t_cfg)
    for b, ber in enumerate(bers):
        want = DRAWN[(None, tuple(seeds[0, b].tolist()))]
        got = t_sweep.cim_inject_pytree_batched(
            t_stores, seeds[0, b], t_fi_ops.ber_to_threshold(ber))
        for path in ("embed", "unembed"):
            # a CIMStore flattens to (man, sign, exp, codewords, cache)
            for i, plane in enumerate(("man", "sign", "exp", "codewords")):
                a = want.get(f"{path}/{i}")
                g = getattr(got[path], plane)
                assert (a is None) == (g is None)
                if a is not None:
                    assert _same_bits(a, g), (ber, path, plane)
        assert got["groups/blk0/mlp/w_in"].shape[0] == n_trials
        assert got["groups/blk0/mlp/w_in"].stride(0) == 0     # a view


def test_full_width_fields_refuse_the_counter_space():
    """Fig. 2 on full-width olmo-1b: the layer-stacked w_gate reshapes to
    [16*2048, 8192] (2^28 elements) and both packages refuse it with the
    same error, checked on shapes only."""
    jcfg = j_get_config("olmo-1b")
    shapes = jax.eval_shape(lambda k: j_lm.init_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as j_err:
        jax.eval_shape(lambda p: j_sweep.inject_pytree_batched(
            p, jnp.zeros((2,), jnp.uint32), jnp.uint32(5), "full",
            interpret=True), shapes)
    flat = {path: torch.zeros(()).expand(leaf.shape)
            for path, leaf in t_tree.flatten(shapes).items()}
    assert list(flat) == list(_jax_flat(shapes))
    with pytest.raises(ValueError) as t_err:
        t_res.characterize_fields(7, flat, lambda p: 0.0, (1e-3,),
                                  n_trials=2, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    assert "32768x8192" in str(t_err.value)


def test_int_seed_expands_to_default_seeds_on_cnn(cnn):
    """An int seed is ``default_seeds``; Fig. 6 on the CNN packs only its
    2-D leaves (dense, head) and passes the HWIO conv kernels through as
    views."""
    _, tp, _, t_eval, _ = cnn
    kw = dict(bers=(1e-2,), n_trials=3, protects=("one4n",), device="cpu")
    by_int = t_res.characterize_protection(11, tp, t_eval, **kw)
    by_arr = t_res.characterize_protection(
        t_sweep.default_seeds(11, 1, 1, 3), tp, t_eval, **kw)
    assert [(r.accuracies, r.corrected, r.uncorrectable) for r in by_int] == \
        [(r.accuracies, r.corrected, r.uncorrectable) for r in by_arr]
    assert by_int[0].corrected > 0
    stores, _ = t_cim.deploy_pytree_impl(tp, t_cim.CIMConfig(**CIM_CFG))
    assert [p for p, v in stores.items() if t_cim._is_store(v)] == \
        ["dense", "head"]
    batched = t_sweep.cim_inject_pytree_batched(stores, [1, 2, 3], 5)
    assert batched["conv1"].shape == (3, 3, 3, 3, 32)
    assert batched["conv1"].stride(0) == 0 and torch.equal(
        t_sweep.trial_params(batched, 2)["conv1"], tp["conv1"])


def test_engine_refusals():
    plan = t_sweep.SweepPlan(bers=(1e-3,), n_trials=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        t_sweep.SweepEngine(dataclasses.replace(plan, backend="xla"),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        t_sweep.SweepPlan(bers=(1e-3,), backend="tpu")
    with pytest.raises(ValueError, match="unknown fault model"):
        t_sweep.SweepPlan(bers=(1e-3,), fault_models=("gamma:rate=0.1",))
    assert t_sweep.SweepPlan(bers=(1e-3,), fault_models=(
        "burst:rate=0.1",)).n_arms("fields") == 4
    eng = t_sweep.SweepEngine(plan, device="cpu")
    with pytest.raises(ValueError, match="n_trials"):
        t_res.characterize_fields(0, {}, None, (1e-3,), n_trials=3,
                                  engine=eng)
    with pytest.raises(ValueError, match="seeds of shape"):
        eng.run_fields(np.zeros((2, 1, 2), np.uint32),
                       {"w": torch.zeros(4, 4)}, lambda p: 0.0)
    with pytest.raises(ValueError, match="expected cpu"):
        eng.run_fields(0, {"w": torch.zeros(4, 4, device="meta")},
                       lambda p: 0.0)
    seeds = t_sweep.default_seeds(5, 4, 2, 3)
    assert seeds.dtype == np.uint32 and seeds.shape == (4, 2, 3)
    assert np.array_equal(seeds, t_sweep.default_seeds(5, 4, 2, 3))
