"""The port's block-FP matmul (K5's plain version and wrappers) against the
JAX reference.

Packing is bitwise. The port's dequantization builds ``2^(e-15)`` in the
fp32 exponent field, so it equals the aligned weights bit for bit for every
exponent; the reference computes ``jnp.exp2(e - 15)``, which XLA's CPU
backend rounds a few ulp off at e in {0, 2, 28, 30} (ROADMAP Queue 3), so
the two are bitwise equal at every other exponent and the gap at those four
is measured and bounded here. Matmuls agree within 1e-5 (fp32, different
summation orders), as ``tests/test_kernels.py`` holds the reference's
kernel to its own oracle; the reference's Pallas kernel runs in interpret
mode, compiled once per case with ``jax.jit``. Exponent bytes from 143 up,
which ``cim_linear`` takes from any uint8 plane, give ``±inf`` in both
packages. The tile variant's TF32 split (``ref.split_tf32``) is checked
here in float64: weights exact in TF32, the split's residual, and the
recipe against the reference's kernel. The ``gpu`` cases hold the CUDA
kernel against its plain version on a card (an all-256-exponent plane and
the tile variant's ragged strides, n_group 12 and K = 1 among them; repeat
calls bitwise) and skip without one; they need no jax, so they run on the
card's machine.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bfp_matmul import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.bfp_matmul import ops as t_ops  # noqa: E402
from repro_torch.kernels.bfp_matmul import ref as t_ref  # noqa: E402

try:    # the reference; the card's machine runs the gpu cases without it
    import jax
    import jax.numpy as jnp
    from repro.core import align as j_align
    from repro.kernels.bfp_matmul import ops as j_ops
    from repro.kernels.bfp_matmul import ref as j_ref
    from repro.kernels.bfp_matmul.kernel import bfp_matmul_pallas
except ImportError:
    jax = None

TOL = 1e-5
INEXACT_EXP2 = (0, 2, 28, 30)   # exponents where the reference's exp2 is off


def _need_jax():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def _aligned(rng, k, n, n_group=8, scale=0.05):
    """Exponent-aligned fp16-grid weights, aligned once by the reference
    (numpy f32), so both packages pack the same matrix."""
    _need_jax()
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    w_al, _ = j_align.align_matrix(jnp.asarray(w), j_align.AlignmentConfig(
        n_group=n_group, index=2))
    return np.array(w_al, np.float32)      # a writable copy


def _planes(w_al, n_group):
    man, exp = t_ref.pack_bfp(torch.from_numpy(w_al), n_group)
    return man, exp


def _j_planes(man, exp):
    return (jnp.asarray(man.view(torch.int16).numpy().view(np.uint16)),
            jnp.asarray(exp.numpy()))


@pytest.mark.parametrize("n_group", [4, 8, 16])
def test_pack_bfp_bitwise(n_group):
    w_al = _aligned(np.random.default_rng(n_group), 256, 96, n_group)
    man, exp = t_ref.pack_bfp(torch.from_numpy(w_al), n_group)
    j_man, j_exp = j_ref.pack_bfp(jnp.asarray(w_al), n_group)
    assert man.dtype == torch.uint16 and exp.dtype == torch.uint8
    assert np.array_equal(man.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(j_man))
    assert np.array_equal(exp.numpy(), np.asarray(j_exp))


def _blocks_at_every_exponent(rng, exps, n_group=8, n=64):
    """Aligned fp16 weights: one block row per exponent in ``exps``, random
    signs and mantissas (the fp16 grid at that exponent)."""
    k = len(exps) * n_group
    e = np.repeat(np.asarray(exps, np.uint16), n_group)[:, None]
    m = rng.integers(0, 1024, (k, n), dtype=np.uint16)
    s = rng.integers(0, 2, (k, n), dtype=np.uint16)
    bits = (s << 15) | (e << 10) | m
    return bits.view(np.float16).astype(np.float32)


def test_dequant_exact_for_every_exponent():
    rng = np.random.default_rng(0)
    # every normal fp16 exponent: the dequantized planes are the weights
    w = _blocks_at_every_exponent(rng, range(1, 31))
    man, exp = t_ref.pack_bfp(torch.from_numpy(w), 8)
    assert sorted(set(exp.numpy().ravel().tolist())) == list(range(1, 31))
    deq = t_ref.dequant_ref(man, exp, 8).numpy()
    assert np.array_equal(deq.view(np.uint32), w.view(np.uint32))
    # exponents 0 and 31 hold no aligned weight, but the planes define
    # +-(1 + m/1024) * 2^(e-15) there too, exactly
    man = torch.from_numpy(rng.integers(0, 2 ** 16, (16, 32)).astype(
        np.int32)).to(torch.uint16)
    exp = torch.tensor([[0] * 32, [31] * 32], dtype=torch.uint8)
    deq = t_ref.dequant_ref(man, exp, 8).numpy()
    b = man.to(torch.int64).numpy()
    e = np.repeat(exp.numpy().astype(np.float64), 8, axis=0)
    want = np.where(b >> 15, -1.0, 1.0) * (1 + (b & 0x3FF) / 1024.0) \
        * np.exp2(e - 15)
    assert np.array_equal(deq, want.astype(np.float32))


def test_dequant_matches_reference_outside_inexact_exp2():
    _need_jax()
    rng = np.random.default_rng(1)
    man = torch.from_numpy(rng.integers(0, 2 ** 16, (32 * 8, 64)).astype(
        np.int32)).to(torch.uint16)
    exp = torch.from_numpy(np.repeat(np.arange(32, dtype=np.uint8)[:, None],
                                     64, axis=1))
    t = t_ref.dequant_ref(man, exp, 8).numpy().view(np.int32).reshape(32, 8, 64)
    j = np.asarray(j_ref.dequant_ref(*_j_planes(man, exp), 8)) \
        .view(np.int32).reshape(32, 8, 64)
    gaps = {}
    for e in range(32):
        ulps = int(np.abs(t[e].astype(np.int64) - j[e]).max())
        if e in INEXACT_EXP2:
            gaps[e] = ulps
        else:
            assert ulps == 0, (e, ulps)
    # the reference's ulp gap at those four (measured +4/-8/+4/-8 ulp of the
    # scale on the XLA CPU of this repository's reference runs); bounded,
    # not pinned, since it belongs to the XLA build
    assert all(g <= 16 for g in gaps.values()), gaps


def test_dequant_every_exponent_byte():
    """All 256 exponent bytes, which ``cim_linear`` takes from any uint8
    plane. The port is exact everywhere, ``±inf`` from e = 143 (the scale
    overflows fp32) and never NaN. Against the reference: bitwise equal for
    e >= 143 and wherever the reference's ``jnp.exp2(e - 15)`` is exact; where
    it is not, apart by no more than that scale error explains (a weight
    ``frac * scale`` with ``frac < 2`` moves twice the scale's ulps, plus
    one for rounding). The scale error is read from the reference's own
    dequantization of a zero mantissa word, not taken from a list."""
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 16, (256 * 8, 16)).astype(np.int32)
    words[:, :2] = (0, 0x8000)              # +-(1.0 * scale) in every block
    man = torch.from_numpy(words).to(torch.uint16)
    exp = torch.from_numpy(np.repeat(np.arange(256, dtype=np.uint8)[:, None],
                                     16, axis=1))
    t = t_ref.dequant_ref(man, exp, 8).numpy()
    assert not np.isnan(t).any()
    e = np.repeat(np.arange(256, dtype=np.float64), 8)[:, None]
    with np.errstate(over="ignore"):
        want = (np.where(words >> 15 & 1, -1.0, 1.0) * (1 + (words & 0x3FF)
                / 1024.0) * np.exp2(e - 15)).astype(np.float32)
    assert np.array_equal(t.view(np.uint32), want.view(np.uint32))
    assert np.isinf(t[143 * 8:]).all()

    _need_jax()
    j = np.asarray(j_ref.dequant_ref(*_j_planes(man, exp), 8))
    assert not np.isnan(j).any()
    tb, jb = (a.view(np.int32).astype(np.int64).reshape(256, 8, 16)
              for a in (t, j))
    scale_err = jb[:, 0, 0] - tb[:, 0, 0]   # reference scale - exact, ulps
    exact = 0
    for ex in range(256):
        gap = int(np.abs(tb[ex] - jb[ex]).max())
        if ex >= 143 or scale_err[ex] == 0:
            assert gap == 0, (ex, gap)
            exact += 1
        else:
            assert gap <= 2 * abs(int(scale_err[ex])) + 1, \
                (ex, gap, int(scale_err[ex]))
    # the reference's exp2 is exact at most exponents a trained model uses
    assert scale_err[1:28].tolist().count(0) >= 25 and exact >= 140


# the matrices of tests/test_kernels.py:28-72
SHAPES = [(128, 512, 128), (256, 1024, 256), (128, 2048, 384), (8, 512, 128)]
BLOCKS = [(128, 128, 512), (128, 256, 256), (64, 128, 1024)]


def _case(m, k, n, n_group=8, seed=0, x_dtype=torch.float32):
    rng = np.random.default_rng(seed + m + k + n)
    w_al = _aligned(rng, k, n, n_group)
    man, exp = _planes(w_al, n_group)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)) \
        .to(x_dtype)
    return x, man, exp, w_al


def _j_kernel(x, man, exp, n_group=8, bm=128, bn=128, bk=512):
    xj = jnp.asarray(x.to(torch.float32).numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)       # exact: x is on the bf16 grid
    bm = min(bm, x.shape[0])
    f = jax.jit(lambda a, b, c: bfp_matmul_pallas(
        a, b, c, n_group=n_group, block_m=bm, block_n=bn, block_k=bk,
        interpret=True))
    return np.asarray(f(xj, *_j_planes(man, exp)))


@functools.lru_cache(maxsize=None)
def _ref_case(m, k, n, n_group=8):
    """A case and the reference kernel's output on it, computed once per
    process (the plain-version and the split-recipe tests share it)."""
    x, man, exp, w_al = _case(m, k, n, n_group)
    return x, man, exp, w_al, _j_kernel(x, man, exp, n_group)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_reference_kernel_shapes(m, k, n):
    x, man, exp, w_al, j_out = _ref_case(m, k, n)
    out = t_ref.bfp_matmul_ref(x, man, exp).numpy()
    np.testing.assert_allclose(out, j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, x.numpy() @ w_al, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_reference_kernel_dtypes(x_dtype):
    x, man, exp, _ = _case(128, 512, 128, x_dtype=x_dtype)
    out = t_ref.bfp_matmul_ref(x, man, exp).numpy()
    np.testing.assert_allclose(out, _j_kernel(x, man, exp), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_group", [4, 8, 16])
def test_plain_matches_reference_kernel_group_sizes(n_group):
    x, man, exp, _ = _case(128, 512, 128, n_group=n_group)
    out = t_ref.bfp_matmul_ref(x, man, exp, n_group).numpy()
    np.testing.assert_allclose(out, _j_kernel(x, man, exp, n_group),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bm,bn,bk", BLOCKS)
def test_plain_matches_reference_kernel_block_shapes(bm, bn, bk):
    x, man, exp, _ = _case(128, 1024, 256)
    out = t_ref.bfp_matmul_ref(x, man, exp).numpy()
    np.testing.assert_allclose(out, _j_kernel(x, man, exp, 8, bm, bn, bk),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m,k,n", [(5, 72, 40), (3, 512, 130), (130, 520, 128)])
def test_cim_linear_ragged_matches_reference(m, k, n):
    x, man, exp, w_al = _case(m, k, n)
    out, info = t_ops.cim_linear(x, man, exp, with_info=True)
    assert info == {"used_kernel": False}     # a CPU tensor: plain version
    j_out, j_info = j_ops.cim_linear(jnp.asarray(x.numpy()),
                                     *_j_planes(man, exp), with_info=True)
    assert j_info["used_kernel"]
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), x.numpy() @ w_al, rtol=1e-4,
                               atol=1e-4)
    plain = t_ops.cim_linear(x, man, exp, use_kernel=False)
    assert torch.equal(plain, x @ t_ref.dequant_ref(man, exp))


def test_cim_linear_leading_batch_shape():
    x, man, exp, w_al = _case(128, 512, 128)
    x3 = x.reshape(4, 32, 512)
    out = t_ops.cim_linear(x3, man, exp)
    assert out.shape == (4, 32, 128)
    j_out = j_ops.cim_linear(jnp.asarray(x3.numpy()), *_j_planes(man, exp))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=TOL,
                               atol=TOL)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    man = torch.zeros((16, 8), dtype=torch.uint16)
    exp = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.bfp_matmul(torch.zeros((2, 16)), man, exp, n_group=8)
    with pytest.raises(ValueError, match="n_group"):
        t_kernel.bfp_matmul(torch.zeros((2, 16)), man, exp, n_group=4)
    with pytest.raises(ValueError, match="dtypes"):
        t_kernel.bfp_matmul(torch.zeros((2, 16), dtype=torch.float64), man,
                            exp, n_group=8)
    with pytest.raises(ValueError, match="one device"):
        t_ops.cim_linear(torch.zeros((2, 16)), man.to("meta"), exp)


# ------------------------------------------- the tile variant's TF32 split
# K5's tile variant runs on the TF32 tensor cores: every weight is exact in
# TF32, x is split into hi + lo (ref.split_tf32, cvt.rna.tf32.f32 as bit
# operations), and the two exact products hi @ W and lo @ W' (W' = W with
# its +-inf set to 0) give the fp32 product. The card's accumulation is
# checked on the card; here the recipe's arithmetic, emulated in float64.

def test_dequant_weights_exact_in_tf32():
    """Every weight the planes can hold (all 65,536 mantissa words x all 256
    exponent bytes) has its low 13 bits zero and an exponent field that is
    fp32's own: TF32 holds it exactly, so W needs no split."""
    words = torch.arange(2 ** 16, dtype=torch.int32).to(torch.uint16)
    for e0 in range(0, 256, 32):
        man = words[:, None].expand(-1, 32).contiguous()
        exp = torch.arange(e0, e0 + 32, dtype=torch.int32).to(torch.uint8)[None]
        w = t_ref.dequant_ref(man, exp, 2 ** 16)
        bits = w.view(torch.int32)
        assert not bool((bits & 0x1FFF).any()), e0
        hi, lo = t_ref.split_tf32(w)
        assert torch.equal(hi.view(torch.int32), bits)
        assert not bool(lo.any())


def _tf32_round_f64(x):
    """Round half away from zero to 11 significant bits, in float64 (an
    independent statement of cvt.rna.tf32.f32 for normal fp32 x)."""
    x = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def _split_inputs(kind, rng, n=4096):
    """fp32 x of one kind, as uint32 bit patterns, with biased exponents
    24..253: there x - hi and its rounding stay normal (below, lo loses bits
    to fp32's subnormal spacing; above, hi could round to inf)."""
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    expo = rng.integers(24, 254, n, dtype=np.uint32) << 23
    top = rng.integers(0, 1024, n, dtype=np.uint32) << 13     # TF32 bits
    low = rng.integers(0, 2 ** 13, n, dtype=np.uint32)
    if kind == "random":
        bits = (rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))) \
            .astype(np.float32).view(np.uint32)
        return bits[np.abs(bits.view(np.float32)) > 0]
    if kind == "ties":                          # exactly half a TF32 ulp
        low = np.full(n, 0x1000, np.uint32)
    elif kind == "low_bits":                    # every low bit set, or one
        low = np.where(rng.integers(0, 2, n) == 1, 0x1FFF, 0x0001) \
            .astype(np.uint32)
        low[::3] = 0x0FFF
        low[1::3] = 0x1001
    elif kind == "powers_of_two":
        top[:] = 0
        low[:] = 0
    elif kind == "bf16_exact":
        top &= 0x7F << 16
        low[:] = 0
    return sign | expo | top | low


@pytest.mark.parametrize("kind", ["random", "ties", "low_bits",
                                  "powers_of_two", "bf16_exact"])
def test_split_tf32_residual(kind):
    """hi and lo are TF32 (low 13 bits zero), hi is the round-half-away-from
    -zero of x to 11 significant bits, and |x - hi - lo| <= 2^-22 |x|; a
    bf16-exact x is its own hi with lo = 0."""
    bits = _split_inputs(kind, np.random.default_rng(len(kind)))
    x = bits.view(np.float32)
    hi, lo = (a.numpy() for a in t_ref.split_tf32(torch.from_numpy(x.copy())))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(hi.astype(np.float64), _tf32_round_f64(x))
    x64 = x.astype(np.float64)
    resid = np.abs(x64 - hi.astype(np.float64) - lo.astype(np.float64))
    assert (resid <= np.exp2(-22) * np.abs(x64)).all(), float(
        (resid / np.abs(x64)).max())
    if kind == "ties":          # half an ulp rounds away from zero
        assert (np.abs(hi.astype(np.float64)) > np.abs(x64)).all()
    if kind in ("powers_of_two", "bf16_exact"):
        assert np.array_equal(hi, x) and not lo.any()


def _recipe_f64(x, man, exp, n_group):
    """The tile variant's arithmetic in float64: hi @ W + lo @ W'."""
    w = t_ref.dequant_ref(man, exp, n_group).double()
    w0 = torch.where(torch.isinf(w), torch.zeros_like(w), w)
    if x.dtype == torch.bfloat16:           # exact in TF32: one product
        return x.double() @ w
    hi, lo = t_ref.split_tf32(x)
    return hi.double() @ w + lo.double() @ w0


@pytest.mark.parametrize("m,k,n,n_group", [s + (8,) for s in SHAPES]
                         + [(128, 504, 128, 12)])
def test_split_recipe_matches_reference_kernel(m, k, n, n_group):
    x, man, exp, w_al, j_out = _ref_case(m, k, n, n_group)
    out = _recipe_f64(x, man, exp, n_group).numpy()
    np.testing.assert_allclose(out, j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, x.double().numpy() @ w_al.astype(
        np.float64), rtol=TOL, atol=TOL)


def test_split_recipe_every_exponent_byte():
    """On a plane holding all 256 exponent bytes the recipe gives +-inf
    exactly where x @ W does and NaN exactly where x @ W does (x = 0 against
    an inf weight), with random x whose lo part is nonzero; lo @ W without
    the inf lanes zeroed would add NaN wherever lo and hi differ in sign."""
    rng = np.random.default_rng(3)
    n = 4 * 256
    man = torch.from_numpy(rng.integers(0, 2 ** 16, (1, n)).astype(
        np.int32)).to(torch.uint16)
    exp = (torch.arange(n) % 256).to(torch.uint8)[None]
    x = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    x[0] = 0.0
    hi, lo = t_ref.split_tf32(x)
    assert bool((lo[1:] != 0).all())
    got = _recipe_f64(x, man, exp, 1)
    want = x.double() @ t_ref.dequant_ref(man, exp, 1).double()
    for f in (torch.isnan, torch.isposinf, torch.isneginf, torch.isfinite):
        assert torch.equal(f(got), f(want)), f.__name__
    assert not bool(got[1:].isnan().any())
    assert bool(got[1:, 143:256].isinf().all())
    fin = torch.isfinite(want)
    assert bool(((got - want)[fin].abs() <= 2.0 ** -22 * want[fin].abs()).all())
    naive = hi.double() @ t_ref.dequant_ref(man, exp, 1).double() \
        + lo.double() @ t_ref.dequant_ref(man, exp, 1).double()
    assert bool(naive[1:].isnan().any())


# ------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _card_case(m, k, n, n_group, x_dtype, dev, seed=0):
    from repro_torch.core import align as t_align
    g = torch.Generator().manual_seed(seed + m + k + n)
    w = torch.randn((k, n), generator=g) * 0.05
    w_al, _ = t_align.align_matrix(w, t_align.AlignmentConfig(n_group=n_group))
    man, exp = t_ref.pack_bfp(w_al, n_group)
    x = torch.randn((m, k), generator=g).to(x_dtype)
    return x.to(dev), man.to(dev), exp.to(dev), w_al.to(dev)


def _every_exponent_case(m, n, dev, seed=0):
    """One block row (K = n_group = 1) whose N columns cycle through all
    256 exponent bytes, with random signs and mantissas (zero mantissas of
    both signs included), and x = ±1: each output is ±W exactly, so kernel
    and plain version agree bit for bit, ±inf from e = 143 and finite below
    it, never NaN."""
    g = torch.Generator().manual_seed(seed + m + n)
    man = torch.randint(0, 2 ** 16, (1, n), generator=g, dtype=torch.int32)
    man[0, :2] = torch.tensor([0, 0x8000])
    exp = (torch.arange(n) % 256).to(torch.uint8)[None]
    x = torch.randint(0, 2, (m, 1), generator=g) * 2.0 - 1.0   # +-W exactly
    man = man.to(torch.uint16)
    return x.to(dev), man.to(dev), exp.to(dev), \
        t_ref.dequant_ref(man, exp, 1).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,n_group,x_dtype,plane", [
    (5, 72, 40, 8, torch.float32, "aligned"),
    (3, 512, 130, 8, torch.float32, "aligned"),
    (130, 520, 128, 8, torch.float32, "aligned"),
    (4, 2048, 1000, 8, torch.float32, "aligned"),
    (1, 64, 33, 4, torch.float32, "aligned"),
    (64, 256, 96, 16, torch.float32, "aligned"),
    (8, 512, 256, 8, torch.bfloat16, "aligned"),
    (200, 512, 256, 4, torch.bfloat16, "aligned"),
    (4, 1, 1024, 1, torch.float32, "every_exponent_byte"),
    (130, 1, 1024, 1, torch.float32, "every_exponent_byte"),
    # the tile variant's traps: rows that forbid 16-byte copies (N = 130,
    # K = 18), n_group 12 across 32-row stages, K = 1, the real depth, and
    # the smallest tile call
    (130, 72, 130, 8, torch.float32, "aligned"),
    (130, 72, 130, 8, torch.bfloat16, "aligned"),
    (33, 18, 64, 6, torch.float32, "aligned"),
    (96, 600, 256, 12, torch.float32, "aligned"),
    (130, 1, 130, 1, torch.float32, "aligned"),
    (1024, 2048, 512, 8, torch.float32, "aligned"),
    (9, 256, 128, 8, torch.float32, "aligned")])
def test_cuda_kernel_matches_plain_version(m, k, n, n_group, x_dtype, plane):
    dev = _cuda()
    if plane == "aligned":
        x, man, exp, w_al = _card_case(m, k, n, n_group, x_dtype, dev)
    else:
        x, man, exp, w_al = _every_exponent_case(m, n, dev)
    before = t_kernel.launch_counts[t_kernel.K5]
    out, info = t_ops.cim_linear(x, man, exp, n_group=n_group, with_info=True)
    assert info["used_kernel"]
    assert t_kernel.launch_counts[t_kernel.K5] == before + 1
    torch.cuda.synchronize()
    want = t_ref.bfp_matmul_ref(x, man, exp, n_group)
    if plane == "aligned":
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   rtol=TOL, atol=TOL)
    else:
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        sat = (torch.arange(n) % 256 >= 143).to(dev)
        assert not bool(out.isnan().any())
        assert bool(out[:, sat].isinf().all())
        assert bool(out[:, ~sat].isfinite().all())
    again = t_ops.cim_linear(x, man, exp, n_group=n_group)   # fixed order
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))
    eye = torch.eye(k, device=dev)
    probe = t_ops.cim_linear(eye, man, exp, n_group=n_group)
    assert torch.equal(probe.view(torch.int32), w_al.view(torch.int32))
