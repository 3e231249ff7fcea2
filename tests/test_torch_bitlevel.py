"""Parity of the port's bit-level core with the JAX reference.

bitops, bitpack, ECC words and the counter-PRNG helpers must agree bit for
bit on the same numpy-drawn inputs, including flipped check bits (mirrors
``tests/test_bitops.py`` and ``tests/test_ecc.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitops as j_bitops  # noqa: E402
from repro.core import bitpack as j_bitpack  # noqa: E402
from repro.core import cim as j_cim  # noqa: E402
from repro.core import ecc as j_ecc  # noqa: E402
from repro.kernels.fault_inject.kernel import hash_u32 as j_hash  # noqa: E402
from repro.kernels.fault_inject.ops import ber_to_threshold as j_thr  # noqa: E402
from repro_torch.core import bitops, bitpack, ecc  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.kernels.fault_inject.ops import ber_to_threshold, hash_u32  # noqa: E402

# jnp.exp2 on XLA's CPU backend lands a few ulp off these powers of two; the
# port builds them exactly (ROADMAP Queue 3).
XLA_INEXACT_EXP2 = {-15, -13, 13, 15}


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint64).astype(np.uint32)


def test_fp16_fields_and_widening_all_bit_patterns():
    """Every fp16 bit pattern: fields split and recombine identically, and
    widening to float32 keeps NaN payloads exactly as the reference does."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    j_s, j_e, j_m = (np.asarray(t) for t in j_bitops.split_fields(
        jnp.asarray(bits).view(jnp.float16).astype(jnp.float32)))
    x16 = torch.from_numpy(bits.copy()).view(torch.float16)
    t_s, t_e, t_m = bitops.split_fields(x16.to(torch.float32))
    finite = np.isfinite(bits.view(np.float16))
    for a, b in ((j_s, t_s), (j_e, t_e), (j_m, t_m)):
        assert np.array_equal(a[finite], b.numpy()[finite])
    s, e, m = (torch.from_numpy(v.astype(np.int64))
               for v in ((bits >> 15) & 1, (bits >> 10) & 31, bits & 1023))
    want = np.asarray(j_bitops.combine_fields(
        jnp.asarray(s.numpy()), jnp.asarray(e.numpy()),
        jnp.asarray(m.numpy())).astype(jnp.float32)).view(np.uint32)
    got = bitops.fields_to_f32(s, e, m).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert np.array_equal(bitops.to_bits(x16).numpy(), bits)


def test_quantize_and_exponent_range():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-12, 10, 4096))
         ).astype(np.float32)
    assert np.array_equal(
        np.asarray(j_bitops.quantize_to_format(jnp.asarray(x))),
        bitops.quantize_to_format(torch.from_numpy(x)).numpy())
    be = np.arange(0, 31)
    j_ll, j_ul = (np.asarray(v) for v in j_bitops.exponent_range(jnp.asarray(be)))
    t_ll, t_ul = (v.numpy() for v in bitops.exponent_range(torch.from_numpy(be)))
    assert np.array_equal(t_ll, np.ldexp(np.float32(1), be - 15).astype(np.float32))
    differ = {int(e) - 15 for e in be if j_ll[e] != t_ll[e] or j_ul[e] != t_ul[e]}
    assert differ <= XLA_INEXACT_EXP2


def test_bitpack_primitives():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, (4, 64), dtype=np.uint64).astype(np.uint32)
    jw = [jnp.asarray(w) for w in words]
    tw = [_u32(w) for w in words]
    assert np.array_equal(np.asarray(j_bitpack.parity32(jw[0])),
                          _np(bitpack.parity32(tw[0])))
    masks = np.asarray([0xFFFFFFFF, 0x0F0F0F0F, 0, 0x80000001], np.uint32)
    assert np.array_equal(np.asarray(j_bitpack.masked_parity(jw, masks)),
                          _np(bitpack.masked_parity(tw, masks)))
    for start, nbits in ((0, 32), (5, 40), (31, 70), (64, 64), (100, 20)):
        a = j_bitpack.extract_window(jw, start, nbits)
        b = bitpack.extract_window(tw, start, nbits)
        assert all(np.array_equal(np.asarray(x), _np(y)) for x, y in zip(a, b))
        jd = [jnp.zeros(64, jnp.uint32) for _ in range(4)]
        td = [torch.zeros(64, dtype=torch.int64) for _ in range(4)]
        j_bitpack.or_window(jd, jw[:2], start % 60, min(nbits, 64))
        bitpack.or_window(td, tw[:2], start % 60, min(nbits, 64))
        assert all(np.array_equal(np.asarray(x), _np(y)) for x, y in zip(jd, td))
    for pos in (0, 1, 3, 31, 32, 63, 100):
        for jf, tf in ((j_bitpack.insert_zero_bit, bitpack.insert_zero_bit),
                       (j_bitpack.delete_bit, bitpack.delete_bit)):
            assert all(np.array_equal(np.asarray(x), _np(y))
                       for x, y in zip(jf(jw, pos), tf(tw, pos)))
    bits = rng.integers(0, 2, (8, 77)).astype(np.uint8)
    packed = np.asarray(j_bitpack.pack_bits_words(jnp.asarray(bits), 77))
    assert np.array_equal(packed, _np(bitpack.pack_bits_words(
        torch.from_numpy(bits), 77)))
    assert np.array_equal(bitpack.unpack_words(_u32(packed), 77).numpy(), bits)
    assert np.array_equal(j_bitpack.word_masks(77, 4), bitpack.word_masks(77, 4))


def _flip(code_words, n_bits, rng, max_flips=3):
    """Random 0..max_flips flips per codeword over its stored bits (data,
    Hamming check bits and the overall parity bit alike)."""
    out = code_words.copy()
    for idx in np.ndindex(out.shape[:-1]):
        for p in rng.choice(n_bits, rng.integers(0, max_flips + 1), replace=False):
            out[idx + (p // 32,)] ^= np.uint32(1 << (p % 32))
    return out


@pytest.mark.parametrize("d", [6, 10, 72, 84, 104])
def test_secded_packed_words(d):
    rng = np.random.default_rng(d)
    jc, tc = j_ecc.SecdedCode(d), ecc.SecdedCode(d)
    assert (jc.n, jc.r, jc.code_words) == (tc.n, tc.r, tc.code_words)
    assert np.array_equal(jc.code_word_masks, tc.code_word_masks)
    data = rng.integers(0, 2 ** 32, (64, tc.data_words), dtype=np.uint64
                        ).astype(np.uint32) & j_bitpack.word_masks(d)
    cw = np.asarray(jc.encode_packed(jnp.asarray(data)))
    assert np.array_equal(cw, _np(tc.encode_packed(_u32(data))))
    bad = _flip(cw, tc.n, rng)
    for a, b in zip(jc.syndrome_packed(jnp.asarray(bad)),
                    tc.syndrome_packed(_u32(bad))):
        assert np.array_equal(np.asarray(a), b.numpy())
    jd, js = jc.decode_packed(jnp.asarray(bad))
    td, ts = tc.decode_packed(_u32(bad))
    assert np.array_equal(np.asarray(jd), _np(td))
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert set(ts.numpy().tolist()) == {0, 1, 2}


@pytest.mark.parametrize("n_group", [4, 8, 16])
def test_one4n_packed_codec(n_group):
    rng = np.random.default_rng(100 + n_group)
    jc = j_ecc.One4NRowCodec(n_group=n_group)
    tc = ecc.One4NRowCodec(n_group=n_group)
    exp = rng.integers(0, 31, (12, 16)).astype(np.uint8)
    signs = rng.integers(0, 2, (12, n_group, 16)).astype(np.uint8)
    jsw = np.asarray(jc.pack_signs(jnp.asarray(signs)))
    tsw = tc.pack_signs(torch.from_numpy(signs))
    assert np.array_equal(jsw, _np(tsw))
    assert np.array_equal(tc.unpack_signs(tsw).numpy(), signs)
    cw = np.asarray(jc.encode_packed(jnp.asarray(exp), jnp.asarray(jsw)))
    assert np.array_equal(cw, _np(tc.encode_packed(torch.from_numpy(exp), tsw)))
    bad = _flip(cw, tc.code.n, rng, max_flips=2)
    for a, b in zip(jc.decode_packed(jnp.asarray(bad)),
                    tc.decode_packed(_u32(bad))):
        a, b = np.asarray(a), b.numpy()
        assert np.array_equal(a.astype(np.uint64), b.astype(np.uint64))


def test_counter_prng_helpers():
    rng = np.random.default_rng(7)
    z = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(np.asarray(j_hash(jnp.asarray(z))),
                          _np(hash_u32(_u32(z))))
    assert all(int(j_hash(jnp.uint32(v))) == hash_u32(int(v)) for v in z[:16])
    for ber in (0.0, 1e-9, 1e-5, 1e-4, 1e-3, 0.0123, 0.5, 0.99999997, 1.0):
        assert int(j_thr(ber)) == ber_to_threshold(ber), ber
    for seed, i in ((0, 0), (12345, 7), (0xFFFFFFFF, 0x2002), (99, 2 ** 31)):
        assert int(j_cim.fold_seed(jnp.uint32(seed), i)) == t_cim.fold_seed(seed, i)


@pytest.mark.parametrize("field", ["sign", "exponent", "mantissa", "full",
                                   "exponent_sign"])
def test_field_bit_positions(field):
    want = j_bitops.FP16.field_bit_positions(field)
    got = bitops.FP16.field_bit_positions(field)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_field_bit_positions_rejects_unknown_field():
    with pytest.raises(ValueError, match="unknown field"):
        bitops.FP16.field_bit_positions("payload")
