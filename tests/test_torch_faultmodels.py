"""The port's fault-model zoo (``repro_torch.core.faultmodels``) against the
JAX reference, and the zoo's own contracts on the port's plain routes.

Parity (integer state bit for bit): the grammar and its errors, the kernel
payload, plane geometry and unit seeds; ``plane_thresholds`` for every kind
and axis on a 2-D mantissa, exponent and sign plane and the 4-D codeword
plane; ``cim.inject(model=)`` stores for one4n, per_weight and none; the
dynamic ``read_rows`` gather; the sweep's batched store injection (the
codeword plane's ``col_div``). Plane seeds come from the live
``jax.random``.

Contracts, as ``tests/test_faultmodels.py`` states them for the reference
(single device): i.i.d. equals the legacy streams; every model's flips are
a strict subset of the i.i.d. flips; burst concentrates flips; drift is
monotone in the tick and tick 0 is i.i.d.; a deployment rule's
``fault_model`` drives ``inject``; the sweep's ``fault_models`` axis tags
its rows and keeps the i.i.d. arm's streams.

Drift: the port scales by the correctly rounded ``(1 + rate) ** tick``; the
reference's float32 ``jnp.power`` is one float32 ulp off at some ticks. The
grid test holds the thresholds equal wherever the reference's scale is the
correctly rounded one and bounds the gap by the reference's own error
elsewhere (ROADMAP Queue 3).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import align as j_align  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import deployment as j_dep  # noqa: E402
from repro.core import faultmodels as j_fm  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.kernels.fault_inject.ops import ber_to_threshold as j_thr  # noqa: E402
from repro_torch.convert import store_from_numpy  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.core import deployment as t_dep  # noqa: E402
from repro_torch.core import faultmodels as t_fm  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core.resilience import characterize_protection  # noqa: E402
from repro_torch.kernels.fault_inject.ops import ber_to_threshold  # noqa: E402

PLANES = ("man", "sign", "exp", "codewords")
PROTECTS = ("one4n", "none", "per_weight")
SPECS = ("burst:rate=0.5,length=4,axis=row",
         "burst:rate=0.5,length=4,axis=col",
         "burst:rate=0.5,length=8,axis=bank",
         "correlated:strength=0.8,period=4")
EVERY_KIND = ("iid", "burst:rate=0.3,length=2,axis=row",
              "burst:rate=0.3,length=3,axis=col",
              "burst:rate=0.3,length=2,axis=bank",
              "correlated:strength=0.7,period=2",
              "correlated:strength=1.0,period=1",
              "drift:drift_rate=0.1,tick=7")
# drift-pow grid: the rates and BERs the reference's drift finding covers
DRIFT_RATES = (0.005, 0.01, 0.02, 0.05, 0.1)
DRIFT_BERS = (1e-5, 1e-4, 1e-3, 1e-2)
DRIFT_TICKS = 1025


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _planes_equal(js, ts):
    for name in PLANES:
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(_bits(a), _bits(b.numpy())), name


@functools.lru_cache(maxsize=None)
def _stores(k=64, j=64, seed=0):
    """One reference store per protect mode and the port's copy of it (the
    stores are never written, so the tests share them)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, j)) * 0.1).astype(np.float32)
    w16 = w.astype(np.float16).astype(np.float32)

    def pack(a, b):
        a_al = j_align.align_matrix(a, j_align.AlignmentConfig(8, 2))[0]
        return {p: j_cim.pack(b if p == "per_weight" else a_al,
                              j_cim.CIMConfig(protect=p)) for p in PROTECTS}
    packed = jax.jit(pack)(jnp.asarray(w), jnp.asarray(w16))
    out = {}
    for protect, js in packed.items():
        ts = store_from_numpy({n: getattr(js, n) for n in PLANES}, js.shape,
                              t_cim.CIMConfig(protect=protect))
        out[protect] = (js, ts)
    return out


def _seeds(key):
    return {k: int(v) for k, v in j_cim.plane_seeds(key).items()}


def _flipped(clean, faulty):
    """{plane: flipped-bit mask} of a port store against its clean image."""
    out = {}
    for name in PLANES:
        a = getattr(clean, name)
        if a is not None:
            out[name] = (a.to(torch.int64) ^ getattr(faulty, name)
                         .to(torch.int64)) & 0xFFFFFFFF
    return out


def _flip_words(clean, faulty):
    return sum(int((m != 0).sum()) for m in _flipped(clean, faulty).values())


def _flip_subset(clean, a, b):
    fa, fb = _flipped(clean, a), _flipped(clean, b)
    for name in fa:
        assert int((fa[name] & ~fb[name]).sum()) == 0, name


# ---------------------------------------------------------------- grammar


def test_grammar_parses_and_validates():
    p = t_fm.parse_fault_model("burst:rate=0.3,length=8,axis=col")
    assert (p.kind, p.rate, p.length, p.axis) == ("burst", 0.3, 8, "col")
    assert t_fm.parse_fault_model("") is None
    assert t_fm.parse_fault_model(None) is None
    assert t_fm.parse_fault_model(p) is p
    assert t_fm.parse_fault_model("drift").kind == "drift"
    assert t_fm.parse_fault_model("correlated:strength=0.9").strength == 0.9
    for bad in ("gamma:rate=0.1", "burst:bogus=1", "burst:kind=iid",
                "burst:rate=1.5", "correlated:period=0",
                "drift:drift_rate=-1"):
        with pytest.raises(ValueError):
            t_fm.parse_fault_model(bad)
        with pytest.raises(ValueError):
            j_fm.parse_fault_model(bad)
    with pytest.raises(ValueError):
        t_fm.FaultProcess(kind="burst", axis="diag")
    assert t_fm.FaultProcess.iid() == t_fm.FaultProcess()
    assert t_fm.FaultProcess.burst(0.5, 8, "bank") == \
        t_fm.parse_fault_model("burst:rate=0.5,length=8,axis=bank")
    assert t_fm.FaultProcess.correlated(0.7, 2).period == 2
    assert t_fm.FaultProcess.drift(0.1, 3).tick == 3
    hash(p)


@pytest.mark.parametrize("spec", EVERY_KIND + ("burst", "correlated",
                                               "drift:tick=5"))
def test_process_and_payload_match_reference(spec):
    jp, tp = j_fm.parse_fault_model(spec), t_fm.parse_fault_model(spec)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    want = tuple(int(v) for v in j_fm.model_scalars(jp))
    assert t_fm.model_scalars(tp) == want
    for shape in ((40, 130), (9, 5, 2, 4)):
        assert t_fm.plane_geometry(shape) == j_fm.plane_geometry(shape)
    seeds = np.asarray(jax.random.bits(jax.random.PRNGKey(len(spec)), (6,),
                                       jnp.uint32))
    assert [t_fm.unit_seed(int(s)) for s in seeds] == \
        [int(v) for v in np.asarray(j_fm.unit_seed(jnp.asarray(seeds)))]
    assert t_fm.MODEL_SEED_SALT == j_fm.MODEL_SEED_SALT


# ----------------------------------------------------- compiled thresholds


@pytest.mark.parametrize("spec", EVERY_KIND)
def test_plane_thresholds_bitwise(spec):
    """Every kind x axis on a 2-D mantissa [K, J], exponent [K/n, J] and
    sign [K/32, J] plane and the 4-D codeword plane [B, G, S, W], at their
    global C-order element indices, for two BERs and several plane seeds."""
    jp, tp = j_fm.parse_fault_model(spec), t_fm.parse_fault_model(spec)
    seeds = np.asarray(jax.random.bits(jax.random.PRNGKey(7), (3,),
                                       jnp.uint32))
    for shape in ((72, 130), (9, 130), (3, 130), (9, 8, 2, 4)):
        n = int(np.prod(shape))
        j_elem = jnp.arange(n, dtype=jnp.uint32).reshape(shape)
        t_elem = torch.arange(n, dtype=torch.int64).reshape(shape)
        for ber in (1e-3, 0.3):
            thr = int(j_thr(ber))
            for seed in seeds:
                want = np.broadcast_to(np.asarray(j_fm.plane_thresholds(
                    jp, jnp.uint32(thr), j_elem, jnp.uint32(seed), shape)),
                    shape)
                got = t_fm.plane_thresholds(tp, thr, t_elem, int(seed), shape)
                got = np.broadcast_to(np.asarray(got.numpy() if isinstance(
                    got, torch.Tensor) else got), shape)
                assert np.array_equal(got.astype(np.uint64),
                                      want.astype(np.uint64)), (shape, ber)
                # only drift raises a threshold; the others thin the stream
                assert tp.kind == "drift" or (got <= thr).all()


def test_drift_thresholds_against_reference_pow():
    """The drift grid (rates 0.005-0.1, ticks 0-1024, BER 1e-5-1e-2): where
    the reference's float32 scale equals the correctly rounded one the
    thresholds are equal; elsewhere the gap is at most what the reference's
    own scale error makes of the threshold (plus one for the truncation),
    and the count of such cells is printed."""
    ticks = np.arange(DRIFT_TICKS)
    off_cells = off_thr = 0
    for rate in DRIFT_RATES:
        base = jnp.float32(1.0) + jnp.float32(rate)
        ref_scale = np.asarray(jnp.power(base, jnp.asarray(ticks,
                                                           jnp.float32)))
        exact = np.asarray([t_fm.drift_scale(rate, t) for t in ticks])
        same = ref_scale == exact
        off_cells += int((~same).sum())
        with np.errstate(invalid="ignore"):      # inf - inf where both overflow
            diff = np.abs(ref_scale.astype(np.float64) - exact)
        assert (same | (diff <= np.spacing(exact))).all()   # one float32 ulp
        for ber in DRIFT_BERS:
            thr = int(j_thr(ber))
            want = np.asarray(j_fm.drift_threshold(jnp.uint32(thr), rate,
                                                   jnp.asarray(ticks)))
            got = np.asarray([t_fm.drift_threshold(thr, rate, t)
                              for t in ticks], np.uint64)
            want = want.astype(np.uint64)
            assert np.array_equal(got[same], want[same]), (rate, ber)
            gap = np.abs(got.astype(np.int64) - want.astype(np.int64))
            # the scale's error times the threshold, then one float32 ulp
            # of the product's own rounding, then the truncation
            prod = np.maximum(got, want).astype(np.float32)
            with np.errstate(invalid="ignore"):
                bound = np.ceil(np.float64(np.float32(thr)) * diff) \
                    + np.spacing(prod).astype(np.float64) + 1
            sat = (want == 0xFFFFFFFF) | (got == 0xFFFFFFFF)
            assert (gap[~same & ~sat] <= bound[~same & ~sat]).all()
            off_thr += int((gap != 0).sum())
    print(f"drift grid: the reference's float32 pow is not correctly rounded "
          f"at {off_cells} of {len(DRIFT_RATES) * DRIFT_TICKS} (rate, tick) "
          f"cells; {off_thr} of "
          f"{len(DRIFT_RATES) * DRIFT_TICKS * len(DRIFT_BERS)} thresholds "
          f"differ there")
    # tick 0 is the identity; a large tick saturates instead of wrapping
    assert t_fm.compiled_threshold(t_fm.FaultProcess.drift(0.5), 123) == 123
    assert t_fm.drift_threshold(ber_to_threshold(0.005), 0.5, 1000) == \
        0xFFFFFFFF


# ---------------------------------------------------- stores vs reference


@pytest.mark.parametrize("spec", SPECS + ("drift:drift_rate=0.5,tick=4",))
def test_inject_with_model_matches_reference(spec):
    """``cim.inject(model=)`` stores bitwise for one4n, none and per_weight,
    and the dynamic ``read_rows`` gather under the model equals the
    reference's and the rows of the injected image."""
    key = jax.random.PRNGKey(21)
    seeds = _seeds(key)
    jp, tp = j_fm.parse_fault_model(spec), t_fm.parse_fault_model(spec)
    idx = np.asarray([[0, 9, 63], [31, 32, 5]], np.int32)
    thr = ber_to_threshold(0.02)
    stores = _stores()

    def reference(st, i):   # every protect mode in one compile
        return {p: (j_cim.inject(key, s, 0.02, "full", model=jp),
                    j_cim.read_rows(s, i, seeds=j_cim.plane_seeds(key),
                                    thr_man=jnp.uint32(thr),
                                    thr_meta=jnp.uint32(thr), model=jp))
                for p, s in st.items()}
    ref = jax.jit(reference)({p: s[0] for p, s in stores.items()},
                             jnp.asarray(idx))
    for protect, (_, ts) in stores.items():
        want, j_rows = ref[protect]
        got = t_cim.inject(seeds, ts, 0.02, "full", model=tp)
        _planes_equal(want, got)
        j_rows = np.asarray(j_rows)
        t_rows = t_cim.read_rows(ts, torch.from_numpy(idx).long(),
                                 seeds=seeds, thr_man=thr, thr_meta=thr,
                                 model=tp).numpy()
        assert np.array_equal(_bits(j_rows), _bits(t_rows)), protect
        w_inj = t_cim.read(got)[0].numpy()
        assert np.array_equal(_bits(t_rows), _bits(w_inj[idx])), protect


def test_sweep_batched_store_injection_matches_reference():
    """The sweep's batched injection under burst on the col axis (the
    flattened codeword plane's unit is S*W words), bitwise against the
    reference's ``cim_inject_pytree_batched`` on its Pallas kernel; the
    flips are a subset of the i.i.d. ones."""
    stores = _stores(64, 48, seed=3)
    seeds = np.asarray(jax.random.bits(jax.random.PRNGKey(4), (2,),
                                       jnp.uint32))
    thr = ber_to_threshold(0.05)
    for spec in ("burst:rate=0.5,length=2,axis=col",):
        jp, tp = j_fm.parse_fault_model(spec), t_fm.parse_fault_model(spec)
        j_tree = {p: s[0] for p, s in stores.items()}
        t_tree = {p: s[1] for p, s in stores.items()}
        want = jax.jit(lambda st, sd: j_sweep.cim_inject_pytree_batched(
            st, sd, jnp.uint32(thr), interpret=True, model=jp))(
                j_tree, jnp.asarray(seeds))
        got = t_sweep.cim_inject_pytree_batched(t_tree, seeds, thr, model=tp)
        iid = t_sweep.cim_inject_pytree_batched(t_tree, seeds, thr)
        for p in t_tree:
            _planes_equal(want[p], got[p])
            for name in PLANES:
                a, b, c = (getattr(s[p], name) for s in (t_tree, got, iid))
                if a is not None:
                    fm_ = (b.to(torch.int64) ^ a.to(torch.int64)[None])
                    fi_ = (c.to(torch.int64) ^ a.to(torch.int64)[None])
                    assert int((fm_ & ~fi_).sum()) == 0, (spec, p, name)


# ------------------------------------------------- contracts (port alone)


def test_iid_bitwise_equals_legacy_streams():
    seeds = _seeds(jax.random.PRNGKey(11))
    for protect, (_, store) in _stores().items():
        legacy = t_cim.inject(seeds, store, 0.01, "full")
        for model in (None, t_fm.FaultProcess.iid(),
                      t_fm.parse_fault_model("iid"),
                      t_fm.FaultProcess.drift()):     # drift at tick 0
            _planes_equal(legacy, t_cim.inject(seeds, store, 0.01, "full",
                                               model=model))
    # the fused read's plain route: i.i.d. scalars and model are the legacy
    from repro_torch.kernels.cim_read import ops as cr_ops
    store = _stores()["one4n"][1]
    thr = ber_to_threshold(0.005)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 64)).astype(np.float32))
    y0 = cr_ops.cim_linear_store(x, store, device="cpu",
                                 scalars=cr_ops.make_scalars(seeds, thr, thr))
    y1 = cr_ops.cim_linear_store(
        x, store, device="cpu", model="iid",
        scalars=cr_ops.make_scalars(seeds, thr, thr, model="iid"))
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("spec", SPECS)
def test_model_flips_subset_of_iid(spec):
    seeds = _seeds(jax.random.PRNGKey(21))
    model = t_fm.parse_fault_model(spec)
    for protect, (_, store) in _stores().items():
        iid = t_cim.inject(seeds, store, 0.02, "full")
        got = t_cim.inject(seeds, store, 0.02, "full", model=model)
        _flip_subset(store, got, iid)
        assert _flip_words(store, got) < _flip_words(store, iid), \
            (protect, spec)


def test_burst_concentrates_flips():
    seeds = _seeds(jax.random.PRNGKey(22))
    store = _stores(128, 64)["one4n"][1]
    iid = t_cim.inject(seeds, store, 0.02, "full")
    got = t_cim.inject(seeds, store, 0.02, "full",
                       model=t_fm.FaultProcess.burst(rate=0.3, length=4))

    def rows_hit(faulty):
        return int((store.man != faulty.man).any(1).sum())
    assert 0 < rows_hit(got) < rows_hit(iid)


def test_drift_monotone_and_tick0_identity():
    seeds = _seeds(jax.random.PRNGKey(23))
    store = _stores()["one4n"][1]
    model = t_fm.FaultProcess.drift(drift_rate=0.5)
    iid = t_cim.inject(seeds, store, 0.005, "full")
    _planes_equal(iid, t_cim.inject(seeds, store, 0.005, "full", model=model))
    prev, prev_n = store, 0
    for tick in (1, 4, 16):
        cur = t_cim.inject(seeds, store, 0.005, "full",
                           model=dataclasses.replace(model, tick=tick))
        _flip_subset(store, prev, cur)
        n = _flip_words(store, cur)
        assert n >= prev_n
        prev, prev_n = cur, n
    assert prev_n > _flip_words(store, iid)


def test_deployment_rule_fault_model():
    with pytest.raises(ValueError):
        t_dep.PolicyRule(fault_model="nope:x=1")
    rule = t_dep.PolicyRule(fault_model="burst:rate=0.4,length=4")
    assert rule.fault_process == t_fm.FaultProcess.burst(0.4, 4)
    assert j_dep.PolicyRule(fault_model=rule.fault_model).fault_process.kind \
        == rule.fault_process.kind
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 0.1)
                         .astype(np.float32))
    dep = t_dep.CIMDeployment.deploy(
        {"w": w}, t_dep.ReliabilityPolicy(rules=(), default=rule))
    store = dep.store_leaves()[0][2]
    seeds = _seeds(jax.random.PRNGKey(5))
    # the rule's process drives inject; an explicit model= overrides it
    via_rule = dep.inject({"w": seeds}, 0.02)
    _planes_equal(t_cim.inject(seeds, store, 0.02, "full",
                               model=rule.fault_process),
                  via_rule.store_leaves()[0][2])
    via_override = dep.inject({"w": seeds}, 0.02, model="iid")
    _planes_equal(t_cim.inject(seeds, store, 0.02, "full"),
                  via_override.store_leaves()[0][2])
    # the dynamic runtime carries a non-i.i.d. process; a drift read folds
    # its read position into the thresholds and hands on tick 0
    rt = dep.runtime(seeds, 0.01, model="drift:drift_rate=0.1")
    thr = ber_to_threshold(0.01)
    assert rt["model"].kind == "drift" and "model" not in dep.runtime(
        seeds, 0.01, model="iid")
    tm, tt, m = t_dep.read_thresholds(rt, 5)
    assert tm == tt == t_fm.drift_threshold(thr, 0.1, 5) and m.tick == 0
    assert t_dep.read_thresholds(rt, 0)[:2] == (thr, thr)


def test_sweep_fault_model_axis():
    params = {"w": torch.from_numpy((np.random.default_rng(0).standard_normal(
        (32, 32)) * 0.1).astype(np.float32))}

    def eval_fn(p):
        return -p["w"].abs().mean()

    seeds = t_sweep.default_seeds(9, 2, 1, 2)
    base = characterize_protection(seeds[:1], params, eval_fn, bers=[1e-3],
                                   n_trials=2, protects=("one4n",),
                                   device="cpu")
    multi = characterize_protection(
        seeds, params, eval_fn, bers=[1e-3], n_trials=2, protects=("one4n",),
        fault_models=("iid", "burst:rate=0.5,length=4"), device="cpu")
    assert [r.fault_model for r in base] == ["iid"]
    assert sorted({r.fault_model for r in multi}) == \
        ["burst:rate=0.5,length=4", "iid"]
    iid_arm = [r for r in multi if r.fault_model == "iid"]
    assert [r.accuracies for r in iid_arm] == [r.accuracies for r in base]
    with pytest.raises(ValueError):
        t_sweep.SweepPlan(bers=(1e-3,), fault_models=("bogus:x=1",))
