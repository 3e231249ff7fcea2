"""The co-design loop of the port against the JAX reference: the closed-form
post-ECC rates, the Fig. 7 training fault schedule (K4's plain version on
the CPU), the policy sweep (K3's plain version), the policy search and the
fine-tuner, and the CNN's loss.

Held bitwise: ``residual_ber_after_secded`` and ``residual_exp_ber`` (plain
Python float arithmetic on both sides); the policy sweep's faulted store
planes, accuracies, mean ECC counts and stored bits at the reference's
plane seeds (its ``_split_schedule`` chain per arm, then
``CIMDeployment.inject``'s per-leaf split and ``plane_seeds``); the
search's trace, assignment and verdict on one scripted engine. The fault
schedule draws the counter PRNG where the reference draws ``jax.random``,
so it is held to the reference's rates: each field's flip count within 5
sigma of the binomial mean. The CNN's loss and gradient agree within
allclose(rtol=1e-4, atol=1e-5) of ``jax.value_and_grad``'s.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as j_api  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.core import ecc as j_ecc  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro.training import codesign as j_cd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import bitops  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.core import ecc as t_ecc  # noqa: E402
from repro_torch.core import fault as t_fault  # noqa: E402
from repro_torch.core import resilience as t_res  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.kernels.fault_inject import kernel as fi_kernel  # noqa: E402
from repro_torch.kernels.fault_inject import ref as fi_ref  # noqa: E402
from repro_torch.models import cnn as t_cnn  # noqa: E402
from repro_torch.training import codesign as t_cd  # noqa: E402
from repro_torch.training import loop as t_loop  # noqa: E402

O0 = {"xla_backend_optimization_level": 0}
BER = 3e-3
FIXTURE_SHAPE = (64, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the workers of a parallel test run share the
    cores, and torch's thread pool on small tensors then spends more time
    waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- closed-form rates


def test_residual_rates_bitwise():
    """``residual_ber_after_secded`` over BERs x codecs x codeword lengths,
    and ``ReliabilityConfig.residual_exp_ber`` for every protection, equal
    the reference's as Python floats."""
    bers = (0.0, -1e-3, 1e-9, 3e-7, 1e-6, 1e-5, 1e-4, 3e-4, 1e-3, 1e-2, 0.1,
            0.5)
    codecs = [(j_ecc.One4NRowCodec(n_group=n, row_weights=rw),
               t_ecc.One4NRowCodec(n_group=n, row_weights=rw))
              for n, rw in ((8, 16), (4, 16), (16, 16), (8, 8))]
    for b in bers:
        assert t_ecc.residual_ber_after_secded(b) == \
            j_ecc.residual_ber_after_secded(b)
        for jc, tc in codecs:
            assert t_ecc.residual_ber_after_secded(b, codec=tc) == \
                j_ecc.residual_ber_after_secded(b, codec=jc)
        for n in (13, 22, 39, 72, 112):
            assert t_ecc.residual_ber_after_secded(b, codeword_bits=n) == \
                j_ecc.residual_ber_after_secded(b, codeword_bits=n)
        if b < 0:
            continue
        for protect in ("one4n", "per_weight", "none"):
            for n_group in (4, 8, 16):
                kw = dict(mode="cim", protect=protect, ber=b,
                          n_group=n_group)
                assert t_api.ReliabilityConfig(**kw).residual_exp_ber == \
                    j_api.ReliabilityConfig(**kw).residual_exp_ber, kw


# ------------------------------------------------------- the policy sweep


@functools.lru_cache(maxsize=None)
def fixture():
    """Two 64x64 leaves, only "a" read by the eval (the reference's
    ``_search_fixture`` shape): the eval's tolerance is computed once on
    the host, so both sides compare bitwise-equal decoded weights with
    the same float32 bounds."""
    rng = np.random.default_rng(0)
    mag = rng.uniform(0.5, 1.0, FIXTURE_SHAPE)
    sign = np.where(rng.random(FIXTURE_SHAPE) < 0.5, 1.0, -1.0)
    a0 = (mag * sign).astype(np.float16).astype(np.float32)
    b = rng.standard_normal(FIXTURE_SHAPE).astype(np.float32)
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
    """One mixed policy arm: One4N on "a"'s exponent/sign cells at a BER
    scale no power of two (its mantissa plane undrawn, its codewords
    drawn), and an unprotected "b" whose mantissa alone is drawn, at a
    scale above 1 (its raw exponent and sign planes undrawn). The
    per-weight codeword plane's draw is Fig. 6's, held in
    ``tests/test_torch_sweep.py``."""
    R, P = dep_mod.PolicyRule, dep_mod.ReliabilityPolicy
    return {"mixed": P(rules=(R("a", protect="one4n", field="exponent_sign",
                                ber_scale=0.3),
                              R("b", protect="none", field="mantissa",
                                ber_scale=2.5)))}


def _reference_plane_seeds(key, n_arms, n_trials, paths):
    """The reference engine's key chain as the port's explicit seeds:
    ``[arm][BER][trial]{path: plane seeds}`` (one BER), plus the trial keys
    themselves."""
    seeds, keys = [], []
    for _ in range(n_arms):
        key, subs = j_sweep._split_schedule(key, n_trials)
        trials, tkeys = [], []
        for t in range(n_trials):
            leaf_keys = jax.random.split(subs[t], len(paths))
            trials.append({p: {k: int(v) for k, v in
                               j_cim.plane_seeds(leaf_keys[i]).items()}
                           for i, p in enumerate(paths)})
            tkeys.append(subs[t])
        seeds.append([trials])
        keys.append(tkeys)
    return seeds, keys


def _plane(store, name):
    return {"codewords": store.codewords}.get(name, getattr(store, name))


def test_run_policies_matches_reference_bitwise():
    """Each arm's faulted store planes (trial by trial, against the
    reference's ``CIMDeployment.inject`` at the trial's key), then the
    sweep's accuracies, mean corrected/uncorrectable counts and stored
    bits, at the reference's plane seeds; the K3 plain version equals the
    port's own ``CIMDeployment.inject`` at the same seeds."""
    jp, tp, j_eval, t_eval = fixture()
    n_trials = 3
    key = jax.random.PRNGKey(11)
    j_arms, t_arms = _arms(j_dep), _arms(t_dep)
    engine = j_sweep.SweepEngine(j_sweep.SweepPlan(
        bers=(BER,), n_trials=n_trials, shard_trials=False))
    j_res = engine.run_policies(key, jp, j_eval, j_arms)
    seeds, keys = _reference_plane_seeds(key, len(j_arms), n_trials,
                                         list(tp))
    fi_kernel.reset_launch_counts()
    t_res_ = t_res.characterize_policies(seeds, tp, t_eval, (BER,), t_arms,
                                         n_trials=n_trials, device="cpu")
    assert fi_kernel.launch_counts == {fi_kernel.K3: 0, fi_kernel.K4: 0}
    assert len(j_res) == len(t_res_) == 1
    for a, b in zip(j_res, t_res_):
        assert (a.ber, a.field, a.protect) == (b.ber, b.field, b.protect)
        assert a.accuracies == b.accuracies, a.protect
        assert (a.corrected, a.uncorrectable, a.stored_bits) == \
            (b.corrected, b.uncorrectable, b.stored_bits), a.protect
    assert t_res_[0].corrected > 0 and min(t_res_[0].accuracies) < 1.0
    for arm, name in enumerate(j_arms):
        jd = j_dep.CIMDeployment.deploy(jp, j_arms[name])
        td = t_dep.CIMDeployment.deploy(tp, t_arms[name])
        inject = jax.jit(lambda d, k: d.inject(k, BER).stores,
                         compiler_options=O0)
        batched = t_sweep.policy_inject_batched(td, seeds[arm][0], BER)
        for t in range(n_trials):
            want = inject(jd, keys[arm][t])
            own = td.inject(seeds[arm][0][t], BER).stores
            got = t_sweep.trial_params(batched, t)
            for path in ("a", "b"):
                for plane in ("man", "sign", "exp", "codewords"):
                    w, g = _plane(want[path], plane), _plane(got[path], plane)
                    o = _plane(own[path], plane)
                    assert (w is None) == (g is None) == (o is None)
                    if w is None:
                        continue
                    w = np.asarray(w)
                    g = g.contiguous().numpy()
                    assert np.array_equal(w.view(np.uint8), g.view(np.uint8)), \
                        (name, t, path, plane)
                    assert torch.equal(o, torch.from_numpy(g)), \
                        (name, t, path, plane)


def test_run_policies_int_seed_and_refusals():
    """An int seed expands through ``policy_seeds``; a non-policy arm, a
    misshapen seed list and a mismatched engine grid raise."""
    _, tp, _, t_eval = fixture()
    arms = _arms(t_dep)
    eng = t_sweep.SweepEngine(t_sweep.SweepPlan(bers=(BER,), n_trials=2),
                              device="cpu")
    by_int = eng.run_policies(5, tp, t_eval, arms)
    by_list = eng.run_policies(t_sweep.policy_seeds(5, 1, 1, 2, tp), tp,
                               t_eval, arms)
    assert [(r.accuracies, r.corrected) for r in by_int] == \
        [(r.accuracies, r.corrected) for r in by_list]
    with pytest.raises(TypeError, match="ReliabilityPolicy"):
        eng.run_policies(5, tp, t_eval, {"x": t_dep.PolicyRule()})
    with pytest.raises(ValueError, match="plane seeds"):
        eng.run_policies([[[{}]]], tp, t_eval, arms)
    with pytest.raises(ValueError, match="n_trials"):
        t_res.characterize_policies(0, tp, t_eval, (BER,), arms, n_trials=3,
                                    engine=eng)


# ------------------------------------------------------- the policy search


class ScriptedEngine:
    """An engine whose arms score from their rules alone: the same moves on
    both sides, and nothing compiles."""

    # accuracy lost per (group, protect, field); at max_drop 0.05 the
    # climb takes b's mantissa-only step first, then two steps of a, and
    # the prune walks b back down
    PENALTY = {"a": {("none", "full"): 0.20, ("none", "mantissa"): 0.19,
                     ("one4n", "full"): 0.01, ("one4n", "mantissa"): 0.02,
                     ("per_weight", "full"): 0.0,
                     ("per_weight", "mantissa"): 0.005},
               "b": {("none", "full"): 0.03, ("none", "mantissa"): 0.005}}
    BITS = {"none": 16, "one4n": 17, "per_weight": 22}

    def __init__(self, ber):
        self.plan = types.SimpleNamespace(bers=(float(ber),))
        self.calls = []

    def score(self, policy):
        acc, bits = 1.0, 1000
        for r in policy.rules:
            acc -= self.PENALTY[r.pattern].get((r.protect, r.field), 0.0)
            bits += self.BITS[r.protect] * (2 if r.field == "full" else 1)
        return acc, bits

    def run_policies(self, key, params, eval_fn, named):
        self.calls.append([n for n, _ in named])
        out = []
        for name, policy in named:
            acc, bits = self.score(policy)
            out.append(types.SimpleNamespace(protect=name, mean=acc,
                                             stored_bits=bits))
        return out


def _searches(space_kw, slo_kw):
    jp, tp, _, _ = fixture()
    groups = (("a", "a"), ("b", "b"))
    j_s = j_cd.PolicySearch(jp, lambda p: 1.0, j_cd.AccuracySLO(**slo_kw),
                            j_cd.SearchSpace(groups=groups, **space_kw),
                            key=jax.random.PRNGKey(0),
                            engine=ScriptedEngine(slo_kw["ber"]))
    t_s = t_cd.PolicySearch(tp, lambda p: 1.0, t_cd.AccuracySLO(**slo_kw),
                            t_cd.SearchSpace(groups=groups, **space_kw),
                            engine=ScriptedEngine(slo_kw["ber"]))
    return j_s, t_s


def _same_result(a, b):
    assert (a.name, a.accuracy, a.clean_accuracy, a.floor, a.slo_met,
            a.stored_bits, a.raw_bits, a.overhead, a.evals) == \
        (b.name, b.accuracy, b.clean_accuracy, b.floor, b.slo_met,
         b.stored_bits, b.raw_bits, b.overhead, b.evals)
    assert a.trace == b.trace


def test_policy_search_matches_reference_move_for_move():
    """``search`` (cost-ascent, then prune) and ``select`` (an SLO met,
    then none met) on one scripted engine: the same engine calls, trace,
    assignment, verdict and deployed cost on both sides."""
    space_kw = dict(protects=("none", "one4n", "per_weight"),
                    fields=("full", "mantissa"))
    j_s, t_s = _searches(space_kw, dict(ber=BER, max_drop=0.05))
    j_r, t_r = j_s.search(), t_s.search()
    _same_result(j_r, t_r)
    assert j_r.assignment == t_r.assignment
    assert j_s.engine.calls == t_s.engine.calls
    assert [(e["action"], e.get("group")) for e in t_r.trace] == \
        [("start", None), ("upgrade", "b"), ("upgrade", "a"),
         ("upgrade", "a"), ("prune", "b")]
    assert t_r.slo_met
    for slo_kw in (dict(ber=BER, max_drop=0.05),
                   dict(ber=BER, max_drop=0.0, min_accuracy=2.0)):
        j_s, t_s = _searches(space_kw, slo_kw)
        arms_j = {"uniform": j_dep.ReliabilityPolicy(
            rules=(j_dep.PolicyRule("a"), j_dep.PolicyRule("b")))}
        arms_t = {"uniform": t_dep.ReliabilityPolicy(
            rules=(t_dep.PolicyRule("a"), t_dep.PolicyRule("b")))}
        for src, arms in ((_arms(j_dep), arms_j), (_arms(t_dep), arms_t)):
            arms.update(src)
        _same_result(j_s.select(arms_j), t_s.select(arms_t))
    assert t_s.trace[-1]["action"] == "select"


def test_search_space_validates():
    with pytest.raises(ValueError, match="at least one"):
        t_cd.SearchSpace(groups=())
    with pytest.raises(ValueError, match="duplicate"):
        t_cd.SearchSpace(groups=(("g", "a"), ("g", "b")))
    with pytest.raises(ValueError, match="protects"):
        t_cd.SearchSpace(groups=(("g", "*"),), protects=("bogus",))
    with pytest.raises(ValueError, match="fields"):
        t_cd.SearchSpace(groups=(("g", "*"),), fields=("sign",))
    space = t_cd.SearchSpace(groups=(("g", "*"),), protects=("none", "one4n"),
                             n_groups=(8, 16))
    assert space.candidates() == j_cd.SearchSpace(
        groups=(("g", "*"),), protects=("none", "one4n"),
        n_groups=(8, 16)).candidates()
    with pytest.raises(ValueError, match="ber"):
        t_cd.AccuracySLO(ber=-1.0)
    with pytest.raises(ValueError, match="must be exactly"):
        t_cd.PolicySearch({}, None, t_cd.AccuracySLO(ber=1e-3),
                          engine=ScriptedEngine(1e-4))
    with pytest.raises(ValueError, match="SearchSpace"):
        t_cd.PolicySearch({}, None, t_cd.AccuracySLO(ber=1e-3),
                          engine=ScriptedEngine(1e-3)).search()


def test_search_policies_finds_the_cheapest_protection():
    """The one-call wrapper on the fixture through the real engine (K3's
    plain version): only "a" needs One4N, and it is ``PolicySearch``'s
    result at the same seeds, a search being reproducible."""
    _, tp, _, t_eval = fixture()
    kw = dict(groups=(("a", "a"), ("b", "b")), max_drop=0.014, n_trials=6,
              seeds=11, protects=("none", "one4n"),
              fields=("exponent_sign",), device="cpu")
    res = t_res.search_policies(tp, t_eval, BER, **kw)
    assert res.slo_met and res.assignment["a"]["protect"] == "one4n"
    assert res.assignment["b"]["protect"] == "none"
    again = t_res.search_policies(tp, t_eval, BER, **kw)
    assert again.trace == res.trace and again.evals == res.evals >= 2


# ------------------------------------------------------- the fault schedule


def _schedule_rel(**kw):
    policy = kw.pop("policy", t_dep.ReliabilityPolicy())
    return RunConfig(policy=policy, ber=kw.pop("ber", 1e-2),
                     inject="dynamic", **kw).rel


def _flips(before, after, field):
    """Flipped bits of ``field`` between two fp16-grid tensors."""
    x = (bitops.to_bits(before).to(torch.int64)
         ^ bitops.to_bits(after).to(torch.int64))
    mask = sum(1 << int(p) for p in bitops.FP16.field_bit_positions(field))
    return int(sum(int(((x & mask) >> p & 1).sum()) for p in range(16)))


def _grid_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((3, 96, 128), generator=g) * 0.05).to(torch.float16) \
        .to(torch.float32)
    return {"embed": w[0], "groups/blk0/mlp/w_in": w, "norm": torch.ones(96),
            "unembed": w[1].T.contiguous()}


def test_fault_schedule_rates_and_determinism(monkeypatch):
    """Each field's flips over the tree within 5 sigma of the binomial mean
    at the reference's rates (exponent/sign at ``residual_exp_ber``,
    mantissa at the BER), 1-D leaves untouched; the same step seed draws
    the same tree bitwise, another step another; a leaf larger than the
    counter space draws in chunks, chunk c from ``fold_seed(seed, c)``."""
    from repro_torch.core.cim import fold_seed
    params = _grid_tree()
    rel = _schedule_rel()
    j_rel = j_api.ReliabilityConfig(mode="cim", ber=1e-2)
    corrupt = t_dep.training_fault_schedule(rel)
    a = corrupt(params, 1234)
    for field, rate in (("exponent_sign", j_rel.residual_exp_ber),
                        ("mantissa", 1e-2)):
        n = sum(w.numel() for w in params.values() if w.ndim >= 2) \
            * len(bitops.FP16.field_bit_positions(field))
        got = sum(_flips(params[p], a[p], field) for p in params)
        mean, sd = n * rate, (n * rate * (1 - rate)) ** 0.5
        assert abs(got - mean) <= 5 * sd, (field, got, mean, sd)
    assert torch.equal(a["norm"], params["norm"])
    b = corrupt(params, 1234)
    assert all(torch.equal(a[p].view(torch.int32), b[p].view(torch.int32))
               for p in params)
    c = corrupt(params, 1235)
    assert not torch.equal(a["embed"], c["embed"])
    # leaf i, field f: fold_seed(fold_seed(seed, f), i); chunks of 2^12
    monkeypatch.setattr(fi_kernel, "MAX_COUNTER_ELEMENTS", 4096)
    w = params["groups/blk0/mlp/w_in"]
    got = t_fault.inject(77, w, 0.05, "mantissa")
    bits = bitops.to_bits(w.reshape(-1, 128))
    want = torch.cat([fi_ref.fault_inject_ref(
        bits[r0:r0 + 32], seed=fold_seed(77, c), ber=0.05,
        positions=range(10)) for c, r0 in enumerate(range(0, 288, 32))])
    assert torch.equal(bitops.to_bits(got.reshape(-1, 128)), want)
    assert len(t_fault.counter_chunks(288, 128)) == 9


def test_inject_pytree_draws_each_leaf_from_its_folded_seed():
    """Leaf i of the tree draws ``inject(fold_seed(seed, i), ...)``; 1-D
    leaves pass through; a model at BER 0 returns the tree as it is."""
    from repro_torch.core.cim import fold_seed
    params = _grid_tree(2)
    model = t_fault.FaultModel(ber=0.02, field="exponent")
    out = t_fault.inject_pytree(5, params, model)
    for i, (p, w) in enumerate(params.items()):
        want = t_fault.inject(fold_seed(5, i), w, 0.02, "exponent") \
            if w.ndim >= 2 else w
        assert torch.equal(out[p].view(torch.int32),
                           want.view(torch.int32)), p
    assert out["norm"] is params["norm"]
    assert _flips(params["embed"], out["embed"], "mantissa") == 0
    off = t_fault.inject_pytree(5, params, t_fault.FaultModel())
    assert all(off[p] is w for p, w in params.items())


def test_fault_schedule_per_rule_branch():
    """Under per-layer rules each leaf draws at its rule's rates and field:
    a mantissa-only rule leaves exponent/sign cells alone, ``deploy=False``
    and ``ber_scale=0`` leave the leaf whole, and a leaf under a default
    that agrees with the legacy uniform rule draws the legacy streams."""
    params = _grid_tree(1)
    R = t_dep.PolicyRule
    policy = t_dep.ReliabilityPolicy(rules=(
        R("embed", field="mantissa", protect="none"),
        R("unembed", deploy=False), R("re:groups/.*", ber_scale=0.0)))
    corrupt = t_dep.training_fault_schedule(_schedule_rel(policy=policy))
    legacy = t_dep.training_fault_schedule(_schedule_rel())
    out, ref = corrupt(params, 9), legacy(params, 9)
    assert _flips(params["embed"], out["embed"], "exponent_sign") == 0
    assert _flips(params["embed"], out["embed"], "mantissa") > 0
    # the legacy tree's exponent/sign flips come first; where one made a
    # NaN, the mantissa pass re-reads it through fp16 (the quiet bit set),
    # in the reference too
    same = ~torch.isnan(ref["embed"])
    assert torch.equal((bitops.to_bits(out["embed"]).to(torch.int64)
                        & 0x3FF)[same],
                       (bitops.to_bits(ref["embed"]).to(torch.int64)
                        & 0x3FF)[same])
    for p in ("unembed", "groups/blk0/mlp/w_in", "norm"):
        assert torch.equal(out[p], params[p]), p
    assert corrupt.rates("embed", params["embed"]) == (0.0, 1e-2)
    assert legacy.rates("embed", params["embed"]) == \
        (j_api.ReliabilityConfig(mode="cim", ber=1e-2).residual_exp_ber, 1e-2)
    assert t_dep.training_fault_schedule(_schedule_rel(ber=0.0)) is None


class _Interrupt(Exception):
    pass


def test_resumed_run_under_the_schedule_equals_uninterrupted(tmp_path):
    """Reduced olmo-1b, 4 steps under the dynamic schedule at BER 1e-3,
    interrupted after its step-2 checkpoint and resumed: losses and every
    leaf bitwise those of the uninterrupted run (the step seed is a
    function of the run seed and the step)."""
    cfg = get_config("olmo-1b").reduced()
    run = RunConfig(steps=4, checkpoint_every=2, warmup_steps=1,
                    learning_rate=1e-3, checkpoint_dir=str(tmp_path),
                    policy=t_dep.ReliabilityPolicy(), ber=1e-3,
                    inject="dynamic")

    def loader():
        return CheckpointableLoader(MarkovLM(cfg.vocab_size, 16, 2, seed=0))

    whole = t_loop.run_training(
        cfg, dataclasses.replace(run, checkpoint_dir=""), loader(),
        device="cpu")

    def stop(step, metrics):
        if step == 2:
            raise _Interrupt
    with pytest.raises(_Interrupt):
        t_loop.run_training(cfg, run, loader(), log_fn=stop, device="cpu")
    assert ckpt.latest_step(run.checkpoint_dir) == 2
    resumed = t_loop.run_training(cfg, run, loader(), device="cpu")
    assert resumed.info["resumed_from"] == 2
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[2:]]
    for p, w in whole.state.params.items():
        assert torch.equal(w, resumed.state.params[p]), p
    # the schedule corrupts the weights before step 0's forward
    clean = t_loop.run_training(
        cfg, dataclasses.replace(run, checkpoint_dir="", ber=0.0, steps=1),
        loader(), device="cpu")
    assert clean.history[0]["loss"] != whole.history[0]["loss"]


# ------------------------------------------------------- the fine-tuner


def test_finetuner_smoke_trains_through_deployment():
    cfg = get_config("olmo-1b").reduced()
    data = MarkovLM(cfg.vocab_size, 8, 2, seed=0)
    ft = t_cd.Finetuner(cfg, t_dep.ReliabilityPolicy(), ber=1e-3,
                        reshape_steps=2, aligned_steps=2, exp_reg_coef=5e-2,
                        seed=0, mesh=None, device="cpu")
    res = ft.run(iter(data))
    losses = [h["loss"] for h in res.info["reshape"]["history"]] + \
        [h["loss"] for h in res.history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    # stage 1 carries the regularizer metric; stage 2 deploys
    assert "exp_penalty" in res.info["reshape"]["history"][0]
    assert res.deployment is not None
    assert res.ecc_stats["stored_bits"] > 0
    # reshape_steps=0 skips stage 1
    res2 = t_cd.Finetuner(cfg, t_dep.ReliabilityPolicy(), reshape_steps=0,
                          aligned_steps=1, mesh="auto",
                          device="cpu").run(iter(data))
    assert res2.info["reshape"]["history"] == []
    # a mesh trains data-parallel (tests/test_torch_mesh_train.py); a mesh
    # that is not ("data", "model") is refused
    with pytest.raises(ValueError, match="'data', 'model'"):
        t_cd.Finetuner(cfg, t_dep.ReliabilityPolicy(), mesh=object(),
                       device="cpu").run(iter(data))
    with pytest.raises(ValueError, match="mesh"):
        t_cd.Finetuner(cfg, t_dep.ReliabilityPolicy(), mesh="2x4",
                       device="cpu").run(iter(data))


def test_codesign_cli_quick_on_cpu(tmp_path, capsys):
    out = tmp_path / "cd.json"
    assert t_cd.main(["--quick", "--reshape-steps", "2", "--aligned-steps",
                      "2", "--device", "cpu", "--json", str(out)]) == 0
    import json
    rep = json.loads(out.read_text())
    assert rep["finetune"]["losses_finite"] and rep["search"]["evals"] == 2
    assert rep["search"]["selected"] in ("uniform_one4n", "embeds_only")


# ------------------------------------------------------- the CNN's loss


def test_cnn_loss_and_gradient_match_reference():
    """The reference's ``init_cnn`` shapes (width 8, 10 classes), fan-in
    normal weights drawn with numpy."""
    rng = np.random.default_rng(3)
    shapes = {"conv1": (3, 3, 3, 8), "conv2": (3, 3, 8, 16),
              "dense": (256, 32), "head": (32, 10)}
    jp = {k: (rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])))
          .astype(np.float32) for k, s in shapes.items()}
    tp = convert.cnn_params_from_jax(jp)
    x = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    (j_loss, j_acc), j_g = jax.jit(jax.value_and_grad(
        j_cnn.cnn_loss, has_aux=True), compiler_options=O0)(jp, x, y)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    t_loss, t_acc = t_cnn.cnn_loss(leaves, torch.from_numpy(x),
                                   torch.from_numpy(y).long())
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    assert float(t_acc) == float(j_acc)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(j_g[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
