"""The port's counter-PRNG fault injection against the JAX reference kernels.

The plain versions of K3 (``fault_inject_batched_ref``) and K4
(``fault_inject_ref``) — what the port runs on the CPU and what the CUDA
kernels are held to on the card — must equal the reference's Pallas kernels
(interpret mode) bit for bit: uint8, uint16 and uint32 planes, ragged
shapes, thresholds 0 / small / saturating, seeds drawn by the live
``jax.random``. K4 keeps the reference's double-precision threshold, which
differs from the sweep's float32 one at BER 1e-3. Under a fault process
(burst, correlated, drift) K3's plain version equals the reference's
batched kernel bit for bit at col_div 1 and S*W. The ``gpu`` cases run the
CUDA kernels against the plain versions and skip without a card; they need
no jax, so they run on the card's machine.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import fault as t_fault  # noqa: E402
from repro_torch.core.bitops import FP16  # noqa: E402
from repro_torch.kernels.fault_inject import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.fault_inject import ops as t_ops  # noqa: E402
from repro_torch.kernels.fault_inject import ref as t_ref  # noqa: E402

try:    # the reference; the card's machine runs the gpu cases without it
    import jax
    import jax.numpy as jnp
    from repro.core import fault as j_fault
    from repro.kernels.fault_inject import kernel as j_kernel
    from repro.kernels.fault_inject import ops as j_ops
except ImportError:
    jax = None

# (torch plane dtype, numpy dtype, positions, shape)
PLANES = {
    "u8": (torch.uint8, np.uint8, tuple(range(5)), (37, 29)),
    "u16": (torch.uint16, np.uint16, tuple(range(10)), (64, 300)),
    "u32": (torch.int32, np.uint32, tuple(range(32)), (17, 130)),
    "u16_ragged": (torch.uint16, np.uint16, (1, 4, 9, 15), (50, 77)),
}
THRESHOLDS = {"zero": 0, "small": 4294967, "ber_3e-2": 128849019,
              "saturating": 0xFFFFFFFF}
FIELDS = ("sign", "exponent", "mantissa", "full", "exponent_sign")
MODEL_SPECS = ("burst:rate=0.5,length=4,axis=row",
               "burst:rate=0.5,length=4,axis=col",
               "burst:rate=0.5,length=8,axis=bank",
               "correlated:strength=0.8,period=4",
               "drift:drift_rate=0.5,tick=3")
_COMPILED = {}


def _need_jax():
    if jax is None:
        pytest.skip("needs the JAX reference package")


def _plane(name, seed=0):
    tdt, ndt, positions, shape = PLANES[name]
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, np.iinfo(ndt).max + 1, shape,
                        dtype=np.uint64).astype(ndt)
    t = torch.from_numpy(bits.view(np.int32) if ndt == np.uint32 else bits)
    assert t.dtype == tdt
    return bits, t, positions


def _seeds(n, salt):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(salt), (n,),
                                      jnp.uint32))


def _reference_batched(name, bits, seeds, thr, positions):
    """The reference kernel in interpret mode, one compile per plane (the
    seeds and threshold are traced operands, as in the sweep)."""
    if name not in _COMPILED:
        _COMPILED[name] = jax.jit(lambda b, s, t: j_kernel.
                                  fault_inject_batched_pallas(
                                      b, s, t, positions=positions,
                                      interpret=True))
    return np.asarray(_COMPILED[name](jnp.asarray(bits), jnp.asarray(seeds),
                                      jnp.uint32(thr)))


@pytest.mark.parametrize("thr", list(THRESHOLDS), ids=list(THRESHOLDS))
@pytest.mark.parametrize("plane", list(PLANES))
def test_plain_batched_matches_reference_kernel(plane, thr):
    _need_jax()
    bits, t_bits, positions = _plane(plane, seed=len(plane))
    seeds = _seeds(3, salt=len(plane) * 10 + len(thr))
    want = _reference_batched(plane, bits, seeds, THRESHOLDS[thr], positions)
    got = t_ops.fault_inject_bits_batched(t_bits, seeds, THRESHOLDS[thr],
                                          positions=positions)
    assert got.dtype == t_bits.dtype and got.shape == (3,) + bits.shape
    got = got.numpy().view(bits.dtype)
    assert np.array_equal(got, want)
    flips = np.unpackbits((got ^ bits[None]).view(np.uint8)).sum()
    if THRESHOLDS[thr] == 0:
        assert flips == 0
    elif THRESHOLDS[thr] == 0xFFFFFFFF:
        assert flips == 3 * bits.size * len(positions)
    # trial t is the single-plane stream at seed seeds[t]
    one = t_ref.fault_inject_batched_ref(t_bits, seeds[1:2], THRESHOLDS[thr],
                                         positions=positions)
    assert np.array_equal(one[0].numpy().view(bits.dtype), got[1])


# (plane, col_div): 2-D planes address columns directly; the flattened
# codeword plane [B, G*S*W] has S*W = 8 words a column group
MODEL_PLANES = (("u8", 1), ("u16", 1), ("u32", 1), ("u32", 8))


@pytest.mark.parametrize("spec", MODEL_SPECS)
def test_plain_batched_model_matches_reference_kernel(spec):
    """K3's plain version under a fault process against the reference's
    batched kernel in interpret mode, bit for bit, on uint8, uint16 and
    uint32 planes, with col_div 1 and S*W; every process's flips are a
    subset of the i.i.d. flips at the same seeds (drift's a superset), and
    each kind thins (or, drift, thickens) them strictly."""
    _need_jax()
    from repro.core import faultmodels as j_fm
    from repro_torch.core import faultmodels as t_fm
    thr = THRESHOLDS["ber_3e-2"]
    for plane, col_div in MODEL_PLANES:
        bits, t_bits, positions = _plane(plane, seed=len(spec))
        seeds = _seeds(3, salt=len(spec) + col_div)
        want = np.asarray(j_ops.fault_inject_bits_batched(
            jnp.asarray(bits), jnp.asarray(seeds), jnp.uint32(thr),
            positions=positions, interpret=True,
            model=j_fm.parse_fault_model(spec), col_div=col_div))
        got = t_ops.fault_inject_bits_batched(
            t_bits, seeds, thr, positions=positions,
            model=t_fm.parse_fault_model(spec), col_div=col_div)
        got = got.numpy().view(bits.dtype)
        assert np.array_equal(got, want), (plane, col_div)
        iid = t_ops.fault_inject_bits_batched(t_bits, seeds, thr,
                                              positions=positions)
        f_model = (got ^ bits[None]).astype(np.uint64)
        f_iid = (iid.numpy().view(bits.dtype) ^ bits[None]).astype(np.uint64)
        small, big = (f_iid, f_model) if spec.startswith("drift") \
            else (f_model, f_iid)
        assert not (small & ~big).any(), (plane, col_div)
        assert np.unpackbits(small.view(np.uint8)).sum() < \
            np.unpackbits(big.view(np.uint8)).sum(), (plane, col_div)


def test_single_seed_keeps_the_double_threshold():
    """K4's threshold is round(ber * 2^32) in doubles: at BER 1e-3 it is one
    below the sweep's float32 threshold, and the port's K4 route uses it."""
    _need_jax()
    assert t_kernel.static_threshold(1e-3) == 4294967
    assert t_ops.ber_to_threshold(1e-3) == 4294968
    assert t_kernel.static_threshold(1.0) == 0xFFFFFFFF
    bits, t_bits, _ = _plane("u16", seed=5)
    for ber, seed in ((1e-3, 17), (0.25, 2 ** 31 + 5), (1.0, 3)):
        want = np.asarray(j_ops.fault_inject_bits(
            jnp.asarray(bits), seed=seed, ber=ber, positions=tuple(range(16)),
            interpret=True))
        got = t_ops.fault_inject_bits(t_bits, seed=seed, ber=ber,
                                      positions=range(16))
        assert np.array_equal(got.numpy(), want), ber
        plain = t_ref.fault_inject_batched_ref(
            t_bits, [seed], t_kernel.static_threshold(ber),
            positions=range(16))[0]
        assert torch.equal(plain, got)


@pytest.mark.parametrize("field", FIELDS)
def test_fault_inject_fp16_matches_reference(field):
    _need_jax()
    rng = np.random.default_rng(3)
    w = np.asarray(rng.standard_normal((24, 40)) * 0.1, np.float16) \
        .astype(np.float32)
    want = np.asarray(j_ops.fault_inject_fp16(jnp.asarray(w), seed=9, ber=0.05,
                                              field=field, interpret=True))
    got = t_ops.fault_inject_fp16(torch.from_numpy(w), seed=9, ber=0.05,
                                  field=field)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    changed = (got.numpy().view(np.uint32) != w.view(np.uint32))
    assert changed.any()
    # flips stay inside the field
    diff = np.asarray(w, np.float16).view(np.uint16) \
        ^ np.asarray(got.numpy(), np.float16).view(np.uint16)
    outside = ~sum(1 << int(p) for p in FP16.field_bit_positions(field)) \
        & 0xFFFF
    assert not (diff & outside).any()


def test_counter_space_guard_matches_reference():
    """2^27 + 1 elements are refused before anything is allocated."""
    _need_jax()
    shape = (2 ** 14, 2 ** 13 + 1)
    plane = torch.zeros((), dtype=torch.uint16).expand(shape)
    with pytest.raises(ValueError) as t_err:
        t_ops.fault_inject_bits_batched(plane, [1], 5, positions=(0,))
    with pytest.raises(ValueError) as j_err:
        jax.eval_shape(lambda b: j_kernel.fault_inject_batched_pallas(
            b, jnp.zeros((1,), jnp.uint32), jnp.uint32(5), positions=(0,)),
            jax.ShapeDtypeStruct(shape, jnp.uint16))
    assert str(t_err.value) == str(j_err.value)
    assert t_kernel.MAX_COUNTER_ELEMENTS == j_kernel.MAX_COUNTER_ELEMENTS
    with pytest.raises(ValueError, match="counter space"):
        t_ops.fault_inject_bits(plane, seed=1, ber=0.1, positions=(0,))
    t_kernel.check_counter_space(2 ** 14, 2 ** 13)      # exactly 2^27 passes


def test_cpu_route_launches_no_kernel():
    t_kernel.reset_launch_counts()
    _, t_bits, positions = _plane("u16")
    t_ops.fault_inject_bits_batched(t_bits, [1, 2], 99, positions=positions)
    t_ops.fault_inject_bits(t_bits, seed=1, ber=0.1, positions=positions)
    assert t_kernel.launch_counts == {t_kernel.K3: 0, t_kernel.K4: 0}
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.fault_inject_batched(t_bits, [1], 99, positions=positions)
    # a fault process runs on the plain route too, and launches nothing
    t_ops.fault_inject_bits_batched(t_bits, [1], 99, positions=positions,
                                    model="burst:rate=0.1,length=4")
    assert t_kernel.launch_counts == {t_kernel.K3: 0, t_kernel.K4: 0}
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.fault_inject_batched(t_bits, [1], 99, positions=positions,
                                      m_thr=5, m_len=4, model_kind="burst")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _popcount(words: torch.Tensor) -> int:
    w = words.to(torch.int64) & 0xFFFFFFFF
    return int(sum(((w >> b) & 1).sum() for b in range(32)))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda",
                                                        marks=pytest.mark.gpu)])
@pytest.mark.parametrize("field", FIELDS)
def test_flip_count_meets_expected_flips(field, device):
    """The batched injection at a ``FaultModel``'s BER flips as many bits as
    ``expected_flips`` says: within 5 binomial sigma at BER 0.05, and every
    field bit at the saturating BER 1 (threshold 0xFFFFFFFF: a draw survives
    only if its hash is 0xFFFFFFFF, which none of these seeds' draws is)."""
    dev = _cuda() if device == "cuda" else torch.device("cpu")
    if jax is not None:
        for ber in (0.0, 0.05):
            want = j_fault.FaultModel(ber=ber, field=field)
            got = t_fault.FaultModel(ber=ber, field=field)
            assert (got.ber, got.field, got.mode, got.is_active()) == \
                (want.ber, want.field, want.mode, want.is_active())
            assert t_fault.expected_flips(1000, ber, field) == \
                j_fault.expected_flips(1000, ber, field)
    _, bits, _ = _plane("u16", seed=5)
    seeds = np.asarray([3, 0xFFFFFFFF, 12345], np.uint32)
    n_values = bits.numel() * seeds.size
    for ber in (0.05, 1.0):
        model = t_fault.FaultModel(ber=ber, field=field)
        positions = model.fmt.field_bit_positions(model.field)
        before = dict(t_kernel.launch_counts)
        got = t_ops.fault_inject_bits_batched(
            bits.to(dev), seeds, t_kernel.static_threshold(model.ber),
            positions=positions)
        assert t_kernel.launch_counts[t_kernel.K3] == \
            before[t_kernel.K3] + (dev.type == "cuda")
        flips = _popcount(got.cpu() ^ bits[None])
        want = t_fault.expected_flips(n_values, model.ber, model.field)
        if ber == 1.0:
            assert flips == want
        else:
            sigma = (want * (1 - ber)) ** 0.5
            assert abs(flips - want) <= 5 * sigma, (flips, want, sigma)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", list(PLANES))
def test_cuda_k3_matches_plain_version(plane):
    dev = _cuda()
    _, t_bits, positions = _plane(plane, seed=11)
    seeds = np.asarray([1, 0xDEADBEEF, 77, 2 ** 31], np.uint32)
    for thr in THRESHOLDS.values():
        before = t_kernel.launch_counts[t_kernel.K3]
        got = t_ops.fault_inject_bits_batched(t_bits.to(dev), seeds, thr,
                                              positions=positions)
        assert t_kernel.launch_counts[t_kernel.K3] == before + 1
        want = t_ref.fault_inject_batched_ref(t_bits, seeds, thr,
                                              positions=positions)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", MODEL_SPECS)
@pytest.mark.parametrize("plane", list(PLANES))
def test_cuda_k3_model_matches_plain_version(plane, spec):
    """K3 under a fault process: bitwise equal to the plain version at
    col_div 1 and 8 (a 16-byte chunk of the uint8 plane then spans two
    column units), and at a ragged plane whose chunks cross rows. A burst
    spec again at length 5 with col_div 3 (units that straddle the burst
    kernel's BURST_ROWS-row tiles) and at rates 0 and 1; every
    spec also on unaligned planes (a view one word into its storage, a
    column slice) and on the codeword geometry (a [40, 33 * 8] uint32
    plane, col_div S*W = 8). One launch a call."""
    dev = _cuda()
    _, t_bits, positions = _plane(plane, seed=12)
    seeds = np.asarray([1, 0xDEADBEEF, 77, 2 ** 31], np.uint32)

    def held(bits, model, col_div, thr, pos=positions):
        before = t_kernel.launch_counts[t_kernel.K3]
        got = t_ops.fault_inject_bits_batched(
            bits, seeds, thr, positions=pos, model=model, col_div=col_div)
        assert t_kernel.launch_counts[t_kernel.K3] == before + 1
        want = t_ops.fault_inject_bits_batched(
            bits.cpu(), seeds, thr, positions=pos, model=model,
            col_div=col_div)
        assert torch.equal(got.cpu(), want), (model, col_div, thr)
    for col_div in (1, 8):
        for thr in (THRESHOLDS["ber_3e-2"], THRESHOLDS["saturating"]):
            held(t_bits.to(dev), spec, col_div, thr)
    specs = [spec]
    if spec.startswith("burst"):
        axis = spec.rsplit("axis=", 1)[1]
        specs += [f"burst:rate={rate},length=5,axis={axis}"
                  for rate in (0.0, 0.5, 1.0)]
    storage = torch.zeros(t_bits.numel() + 1, dtype=t_bits.dtype, device=dev)
    storage[1:] = t_bits.reshape(-1).to(dev)
    offset = storage[1:].view(t_bits.shape)          # contiguous, unaligned
    g = torch.Generator().manual_seed(13)
    cw = torch.randint(-2 ** 31, 2 ** 31, (40, 33 * 8), generator=g,
                       dtype=torch.int64).to(torch.int32).to(dev)
    for model in specs:
        for thr in (THRESHOLDS["ber_3e-2"], THRESHOLDS["saturating"]):
            held(t_bits.to(dev), model, 3, thr)
            held(offset, model, 1, thr)
            held(t_bits.to(dev)[:, 1:], model, 8, thr)
            held(cw, model, 8, thr, pos=tuple(range(32)))


@pytest.mark.gpu
@pytest.mark.parametrize("field", FIELDS)
def test_cuda_k4_matches_plain_version(field):
    dev = _cuda()
    w = torch.randn((1000, 777), generator=torch.Generator().manual_seed(2))
    bits = w.to(torch.float16).view(torch.uint16)
    positions = FP16.field_bit_positions(field)
    before = t_kernel.launch_counts[t_kernel.K4]
    got = t_ops.fault_inject_bits(bits.to(dev), seed=5, ber=1e-3,
                                  positions=positions)
    assert t_kernel.launch_counts[t_kernel.K4] == before + 1
    assert torch.equal(got.cpu(), t_ref.fault_inject_ref(
        bits, seed=5, ber=1e-3, positions=positions))


# (spec of a stacked [L, D, F] leaf, mesh dims): splits on D, on F, on
# both, on D over two axes, and a replicated stack
BLOCK_SPLITS = (((None, "data", "model"), (4, 2)),
                ((None, "model", "data"), (2, 4)),
                ((None, ("data", "model"), None), (2, 2)),
                ((None, None, "data"), (8, 1)),
                ((None, "data", None), (1, 1)))


def test_plain_block_draws_equal_the_whole_draw(monkeypatch):
    """Every block of a stacked plane, drawn at its offsets
    (``fault.inject_block``: K4's plain version over its runs), is bitwise its
    region of the one-device draw. The counter chunk is cut to 2^10
    elements, so the [3 * 24, 40] plane takes 3 chunks whose boundaries
    fall inside the layers' row ranges. At zero offsets ``at`` is the
    plain draw."""
    from repro_torch.distributed import sharding as shlib
    monkeypatch.setattr(t_kernel, "MAX_COUNTER_ELEMENTS", 2 ** 10)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 24, 40), generator=g).to(torch.float16).to(
        torch.float32)
    whole = t_fault.inject(123, x, 0.05, "full")
    assert len(t_fault.counter_chunks(72, 40)) == 3
    for spec, dims in BLOCK_SPLITS:
        runs = 0
        for rank in shlib.ranks_of(("data", "model"), dims):
            lay = shlib.layout_of(shlib.sanitize_spec(rank, spec, x.shape),
                                  x.shape, rank)
            got = t_fault.inject_block(123, lay.cut(x).contiguous(), lay,
                                       0.05, "full")
            want = lay.cut(whole).contiguous()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (spec, rank)
            runs += len(t_fault.block_runs(lay))
        assert runs >= 3, spec
    bits = x.reshape(-1, 40)[:20].to(torch.float16).view(torch.uint16)
    positions = FP16.field_bit_positions("full")
    assert torch.equal(
        t_ops.fault_inject_bits(bits, seed=9, ber=0.05, positions=positions,
                                at=(0, 0, 40)),
        t_ops.fault_inject_bits(bits, seed=9, ber=0.05,
                                positions=positions))
    with pytest.raises(ValueError):       # the block leaves its chunk
        t_ops.fault_inject_bits(bits[:10], seed=9, ber=0.05,
                                positions=positions, at=(20, 0, 40))


@pytest.mark.gpu
def test_cuda_k4_at_offsets_matches_plain_version():
    """K4 at offsets on the card: each block of a stacked plane (split on
    D, on F, on both) bitwise its plain version, one launch a block over
    the table of its runs of rows, ragged column blocks included."""
    from repro_torch.distributed import sharding as shlib
    dev = _cuda()
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 96, 100), generator=g).to(torch.float16).to(
        torch.float32)
    for spec, dims in BLOCK_SPLITS:
        for rank in shlib.ranks_of(("data", "model"), dims):
            lay = shlib.layout_of(shlib.sanitize_spec(rank, spec, x.shape),
                                  x.shape, rank)
            block = lay.cut(x).contiguous()
            before = t_kernel.launch_counts[t_kernel.K4]
            got = t_fault.inject_block(77, block.to(dev), lay, 0.01, "full")
            assert t_kernel.launch_counts[t_kernel.K4] == before + 1
            want = t_fault.inject_block(77, block, lay, 0.01, "full")
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), (spec, rank)
