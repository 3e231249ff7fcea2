"""Parity of the port's packed CIM image with the JAX reference.

For every protection mode and n_group in {4, 8, 16}: alignment, the packed
planes after ``pack`` and after ``inject_with_seeds`` (seeds drawn by the
live reference's ``plane_seeds``), ``read`` weights (NaN payloads included),
static and dynamic ``read_rows``, and ECC counts are bit-identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import align as j_align  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.kernels.fault_inject.ops import ber_to_threshold  # noqa: E402
from repro_torch.convert import store_from_numpy  # noqa: E402
from repro_torch.core import align as t_align  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402

PLANES = ("man", "sign", "exp", "codewords")
# exponents whose jnp.exp2 XLA's CPU backend rounds off (ROADMAP Queue 3):
# blocks aligned to them may land one fp16 ulp apart
XLA_INEXACT_BIASED = {0, 2, 28, 30}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _planes_equal(js, ts):
    for name in PLANES:
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(a).dtype.itemsize == b.element_size(), name
            assert _same(a, b.numpy()), name


def _weights(seed, k=72, j=50):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, j)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_group", [4, 8, 16])
def test_align_matrix_bitwise(n_group):
    w = _weights(n_group, 131, 70)
    cfg = dict(n_group=n_group, index=2)
    jw, je = jax.jit(lambda a: j_align.align_matrix(
        a, j_align.AlignmentConfig(**cfg)))(jnp.asarray(w))
    tw, te = t_align.align_matrix(torch.from_numpy(w), t_align.AlignmentConfig(**cfg))
    je = np.asarray(je)
    assert np.array_equal(je, te.numpy())
    rows = np.repeat(je, n_group, axis=0)[:w.shape[0]]
    exact = ~np.isin(rows, list(XLA_INEXACT_BIASED))
    assert exact.mean() > 0.9
    assert _same(np.asarray(jw)[exact], tw.numpy()[exact])


def _reference(w, protect, n_group, jseeds, thr, idx):
    """The reference's align (or fp16 rounding) -> pack -> inject -> read ->
    static and dynamic read_rows, compiled as one program (one XLA compile
    per case instead of five)."""
    jcfg = j_cim.CIMConfig(n_group=n_group, protect=protect)

    def run(w, seeds, idx):
        if protect == "per_weight":
            w_al = w.astype(jnp.float16).astype(jnp.float32)
        else:
            w_al = j_align.align_matrix(
                w, j_align.AlignmentConfig(n_group=n_group))[0]
        js = j_cim.pack(w_al, jcfg)
        ji = j_cim.inject_with_seeds(js, seeds, thr, thr)
        jw, jst = j_cim.read(ji)
        return (w_al, js, ji, jw, jst, j_cim.read_rows(js, idx),
                j_cim.read_rows(js, idx, seeds=seeds, thr_man=thr,
                                thr_meta=thr))
    return jax.jit(run)(jnp.asarray(w), jseeds, jnp.asarray(idx))


@pytest.mark.parametrize("protect", ["one4n", "none", "per_weight"])
@pytest.mark.parametrize("n_group", [4, 8, 16])
def test_pack_inject_read_bitwise(protect, n_group):
    w = _weights(10 * n_group + len(protect))
    jseeds = j_cim.plane_seeds(jax.random.PRNGKey(n_group))
    seeds = {k: int(v) for k, v in jseeds.items()}
    thr = ber_to_threshold(2e-2)
    idx = np.array([[0, 5, 71], [33, 64, 12]])
    w_al, js, ji, jw, jst, rows, jdyn = _reference(w, protect, n_group,
                                                   jseeds, thr, idx)
    w_al = np.array(w_al)    # a writable copy for torch.from_numpy
    tcfg = t_cim.CIMConfig(n_group=n_group, protect=protect)
    ts = t_cim.pack(torch.from_numpy(w_al), tcfg)
    _planes_equal(js, ts)
    assert (js.stored_bits, js.stored_bytes) == (ts.stored_bits, ts.stored_bytes)

    ti = t_cim.inject_with_seeds(ts, seeds, int(thr), int(thr))
    _planes_equal(ji, ti)
    _planes_equal(ji, store_from_numpy({n: getattr(ji, n) for n in PLANES},
                                       ji.shape, tcfg))

    tw, tst = t_cim.read(ti)
    assert _same(jw, tw.numpy())
    assert (int(jst["corrected"]), int(jst["uncorrectable"])) == \
        (tst["corrected"], tst["uncorrectable"])
    st = t_cim.store_stats(ti)
    assert (st["corrected"], st["uncorrectable"]) == \
        (tst["corrected"], tst["uncorrectable"])

    assert _same(rows, t_cim.read_rows(ts, torch.from_numpy(idx)).numpy())
    tdyn = t_cim.read_rows(ts, torch.from_numpy(idx), seeds=seeds,
                           thr_man=int(thr), thr_meta=int(thr))
    assert _same(jdyn, tdyn.numpy())
    # a dynamic gather equals the same rows of the statically injected image
    assert _same(tdyn.numpy(), tw.numpy()[idx])

