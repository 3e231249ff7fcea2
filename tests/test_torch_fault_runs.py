"""K4 over a table of runs: one draw of a whole leaf or of a block of a
sharded leaf, a float32 leaf's round trip to fp16 bits fused into it.

The plain run-table version (``ref.fault_inject_runs_ref``, what the port
runs on the CPU and what the CUDA kernel is held to on the card) must equal,
bit for bit: the run-by-run composition it replaces (per run of
``fault.block_runs``, ``to_bits`` -> K4's plain version at the run's offsets
from the chunk's folded seed -> ``bits_to_dtype``), on every block of a
3-chunk stack, a whole leaf and a leaf with ragged columns, in uint16 and in
float32 (in place and not); on each chunk of a 3-chunk leaf, the reference's
``fault_inject_pallas`` in interpret mode at the chunk's folded seed; and in
float32 the ``bits_to_dtype(to_bits(x))`` round trip over signed zeros,
subnormals, infinities, NaN payloads, round-to-even ties and values that
round to inf. The counter chunk is cut to 2^10 elements. The ``gpu`` cases
hold the kernel to the plain version with one K4 launch a call; they need
no jax, so they run on the card's machine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bitops  # noqa: E402
from repro_torch.core import fault as t_fault  # noqa: E402
from repro_torch.core.bitops import FP16  # noqa: E402
from repro_torch.core.cim import fold_seed  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.kernels.fault_inject import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.fault_inject import ops as t_ops  # noqa: E402
from repro_torch.kernels.fault_inject import ref as t_ref  # noqa: E402

try:    # the reference; the card's machine runs the gpu cases without it
    import jax.numpy as jnp
    from repro.kernels.fault_inject import kernel as j_kernel
except ImportError:
    jnp = None

# (spec of a stacked [L, D, F] leaf, mesh dims): splits on D, on F, on
# both, on D over two axes, and a replicated stack
BLOCK_SPLITS = (((None, "data", "model"), (4, 2)),
                ((None, "model", "data"), (2, 4)),
                ((None, ("data", "model"), None), (2, 2)),
                ((None, None, "data"), (8, 1)),
                ((None, "data", None), (1, 1)))
# [3, 24, 40]: 3 counter chunks of 2^10 elements whose edges fall inside
# layers; [3, 96, 100]: ragged columns (an F block of 25 or 12 words, so a
# 16-byte chunk spans rows and runs)
STACKS = ((3, 24, 40), (3, 96, 100))
# (plane dtype, in place)
ROUTES = (("u16", False), ("f32", False), ("f32", True))
CHUNK = 2 ** 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(t_kernel, "MAX_COUNTER_ELEMENTS", CHUNK)


def _stack(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.float16).to(torch.float32)


def _blocks(x):
    """Every rank's (layout, contiguous block) of ``x`` over BLOCK_SPLITS."""
    for spec, dims in BLOCK_SPLITS:
        for rank in shlib.ranks_of(("data", "model"), dims):
            lay = shlib.layout_of(shlib.sanitize_spec(rank, spec, x.shape),
                                  x.shape, rank)
            yield lay, lay.cut(x).contiguous()


def _composition(seed, x, layout, ber, positions):
    """The run-by-run draw K4's table replaces: each run of
    ``block_runs(layout)`` goes to fp16 bits, through K4's plain version at
    its offsets from its chunk's folded seed, and back."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for r0, r1, k, row_off in t_fault.block_runs(layout):
        bits = flat[r0:r1] if flat.dtype == torch.uint16 \
            else bitops.to_bits(flat[r0:r1])
        got = t_ref.fault_inject_ref(
            bits, seed=fold_seed(seed, k), ber=ber, positions=positions,
            at=(row_off, layout.offsets[-1], layout.shape[-1]))
        out[r0:r1] = got if flat.dtype == torch.uint16 \
            else bitops.bits_to_dtype(got, flat.dtype)
    return out.reshape(x.shape)


def _draw(route, seed, x, layout, ber, field):
    """The port's draw of ``x`` (a block at ``layout``, or a whole leaf at
    ``layout=None``) by route: uint16 bits, float32, float32 in place."""
    dt, in_place = route
    positions = FP16.field_bit_positions(field)
    if dt == "u16":
        bits = bitops.to_bits(x.reshape(-1, x.shape[-1]))
        if layout is None:
            return t_fault.draw_bits(bits, seed, ber, positions)
        return t_fault.draw_block_bits(bits, layout, seed, ber, positions)
    if layout is None:
        return t_fault.inject(seed, x, ber, field)
    if in_place:
        y = x.clone()
        got = t_fault.inject_block(seed, y, layout, ber, field, in_place=True)
        assert got.data_ptr() == y.data_ptr()
        return got
    return t_fault.inject_block(seed, x, layout, ber, field)


def _whole(shape):
    return shlib.Layout((), tuple(shape), tuple(shape), (0,) * len(shape))


def _bitwise(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def _planes(route, x):
    """What ``route`` draws from the fp16-grid stack ``x``: its fp16 bit
    patterns [R, C] (uint16), or ``x`` itself."""
    return bitops.to_bits(x.reshape(-1, x.shape[-1])) if route[0] == "u16" \
        else x


@pytest.mark.parametrize("stack", STACKS, ids=["3x24x40", "ragged"])
@pytest.mark.parametrize("route", ROUTES, ids=["u16", "f32", "f32_inplace"])
def test_plain_runs_equal_run_by_run_composition(route, stack, small_chunks):
    """Every block of BLOCK_SPLITS, the whole leaf and each leaf's rows as
    one block: the run table's draw equals the run-by-run composition."""
    x = _stack(stack, seed=len(stack) + stack[-1])
    rows = x.numel() // x.shape[-1]
    assert len(t_fault.counter_chunks(rows, x.shape[-1])) >= 3
    n_runs = 0
    positions = FP16.field_bit_positions("full")
    for lay, blk in list(_blocks(x)) + [(_whole(x.shape), x)]:
        want = _composition(123, _planes(route, blk), lay, 0.05, positions)
        got = _draw(route, 123, blk, lay, 0.05, "full")
        assert _bitwise(got, want), (lay.spec, lay.offsets)
        n_runs += len(t_fault.block_runs(lay))
    leaf = _draw(route, 123, x, None, 0.05, "full")
    assert _bitwise(leaf, _composition(123, _planes(route, x),
                                       _whole(x.shape), 0.05, positions))
    assert n_runs > 3 * len(BLOCK_SPLITS)


@pytest.mark.parametrize("chunk", range(3))
def test_plain_runs_match_reference_kernel_per_chunk(chunk, small_chunks):
    """Chunk ``c`` of a 3-chunk leaf's one-table draw equals the reference's
    ``fault_inject_pallas`` (interpret mode) on the chunk's rows from
    ``fold_seed(seed, c)``, in uint16 and through the float32 round trip."""
    if jnp is None:
        pytest.skip("needs the JAX reference package")
    x = _stack((72, 40), seed=7)
    per = CHUNK // 40
    bits = bitops.to_bits(x)
    positions = tuple(range(16))
    got_bits = t_fault.draw_bits(bits, 99, 0.05, positions)
    got_vals = t_fault.inject(99, x, 0.05, "full")
    rows = slice(chunk * per, min((chunk + 1) * per, 72))
    want = np.asarray(j_kernel.fault_inject_pallas(
        jnp.asarray(bits[rows].numpy()), seed=fold_seed(99, chunk), ber=0.05,
        positions=positions, interpret=True))
    assert np.array_equal(got_bits[rows].numpy(), want)
    assert _bitwise(got_vals[rows], bitops.fp16_bits_to_f32(
        torch.from_numpy(want.copy())))
    assert (want != bits[rows].numpy()).any()


def _specials() -> torch.Tensor:
    """float32 words [64, 64]: signed zeros, fp32 and fp16 subnormals and
    their edges, ties of the fp16 grid (even and odd), the largest finite
    fp16 and the values that round to inf, infinities, NaNs with payloads
    (quiet and signalling), then random words."""
    pats = [0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00800000,
            0x33000000, 0x33000001, 0x33400000, 0x33800000, 0x33C00000,
            0x387FC000, 0x387FE000, 0x38800000, 0xB8801000, 0x3F800000,
            0x3F801000, 0x3F803000, 0x3F802FFF, 0x3F801001, 0x477FE000,
            0x477FEFFF, 0x477FF000, 0xC77FF000, 0x47800000, 0x7F7FFFFF,
            0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
            0x7FA00000, 0xFFBFFFFF, 0x7FC02000, 0x7FFFE000, 0x7F802000]
    rng = np.random.default_rng(2)
    words = np.concatenate([np.asarray(pats, np.uint32), rng.integers(
        0, 2 ** 32, 64 * 64 - len(pats), dtype=np.uint64).astype(np.uint32)])
    return torch.from_numpy(words.view(np.float32).reshape(64, 64).copy())


@pytest.mark.parametrize("ber", [0.0, 0.05])
def test_plain_fp32_round_trip_over_specials(ber):
    """The float32 route equals ``bits_to_dtype(to_bits(x))`` around K4's
    plain version bitwise over every special; at threshold 0 it is the
    round trip itself, every element written."""
    x = _specials()
    positions = FP16.field_bit_positions("full")
    got = t_ops.fault_inject_runs(x, ((0, 0, 0),), seed=31, ber=ber,
                                  positions=positions, fold=False)
    want = bitops.bits_to_dtype(t_ref.fault_inject_ref(
        bitops.to_bits(x), seed=31, ber=ber, positions=positions),
        torch.float32)
    assert _bitwise(got, want)
    assert _bitwise(t_ops.fault_inject_fp16(x, seed=31, ber=ber), want)
    if ber == 0.0:
        assert _bitwise(got, bitops.fp16_bits_to_f32(bitops.to_bits(x)))
    else:
        assert not _bitwise(got, bitops.fp16_bits_to_f32(bitops.to_bits(x)))
        y = x.clone()
        t_ops.fault_inject_runs(y, ((0, 0, 0),), seed=31, ber=ber,
                                positions=positions, fold=False, out=y)
        assert _bitwise(y, want)


def test_run_table_reproduces_block_runs_and_counter_chunks(small_chunks):
    """``layout_runs`` is ``block_runs`` without its ends, ``leaf_runs`` is
    ``counter_chunks`` at row 0 of each chunk and a whole layout's runs; the
    device table holds them as int32 [n, 3], made once; tables that leave a
    chunk or skip rows are refused."""
    x = _stack((3, 24, 40), seed=1)
    for lay, _ in _blocks(x):
        runs = t_fault.layout_runs(lay)
        assert runs == tuple((r0, k, off) for r0, _, k, off
                             in t_fault.block_runs(lay))
        assert runs is t_fault.layout_runs(lay)
        rows = lay.block[-2] * (np.prod(lay.block[:-2]) if len(lay.block) > 2
                                else 1)
        t_kernel.check_runs(runs, int(rows), lay.block[-1], lay.offsets[-1],
                            lay.shape[-1])
    leaf = t_fault.leaf_runs(72, 40)
    assert leaf == tuple((r0, c, 0) for c, (r0, _)
                         in enumerate(t_fault.counter_chunks(72, 40)))
    assert leaf == t_fault.layout_runs(_whole((72, 40)))
    assert len(leaf) == 3
    table = t_ops.run_table(leaf, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.tolist() == [list(r)
                                                             for r in leaf]
    assert t_ops.run_table(leaf, torch.device("cpu")) is table
    for bad in ((), ((1, 0, 0),), ((0, 0, 0), (0, 1, 0)),
                ((0, 0, 0), (30, 1, 0))):       # the last leaves its chunk
        with pytest.raises(ValueError):
            t_kernel.check_runs(bad, 72, 40, 0, 40)
    with pytest.raises(ValueError):
        t_ops.fault_inject_runs(torch.zeros((4, 4), dtype=torch.int32),
                                ((0, 0, 0),), seed=1, ber=0.1, positions=(0,))


# ------------------------------------------------------------ on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _one_launch(fn):
    before = t_kernel.launch_counts[t_kernel.K4]
    out = fn()
    torch.cuda.synchronize()
    assert t_kernel.launch_counts[t_kernel.K4] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("stack", STACKS, ids=["3x24x40", "ragged"])
@pytest.mark.parametrize("route", ROUTES, ids=["u16", "f32", "f32_inplace"])
def test_cuda_runs_match_plain_version(route, stack, small_chunks):
    """Every block of BLOCK_SPLITS and the whole leaf, one K4 launch a
    call, bitwise the plain version of the same call."""
    dev = _cuda()
    x = _stack(stack, seed=len(stack) + stack[-1])
    for lay, blk in list(_blocks(x)) + [(None, x)]:
        got = _one_launch(lambda: _draw(route, 123, blk.to(dev), lay, 0.05,
                                        "full"))
        want = _draw(route, 123, blk, lay, 0.05, "full")
        assert _bitwise(got.cpu(), want), (route, lay)


@pytest.mark.gpu
@pytest.mark.parametrize("ber", [0.0, 0.05])
def test_cuda_fp32_round_trip_over_specials(ber):
    """The fused round trip on the card equals ``fp16_bits_to_f32`` of
    torch's own cast on the card around K4's plain version, NaNs included,
    in place and not."""
    dev = _cuda()
    x = _specials().to(dev)
    positions = FP16.field_bit_positions("full")
    got = _one_launch(lambda: t_ops.fault_inject_runs(
        x, ((0, 0, 0),), seed=31, ber=ber, positions=positions, fold=False))
    want = bitops.bits_to_dtype(t_ref.fault_inject_ref(
        bitops.to_bits(x), seed=31, ber=ber, positions=positions),
        torch.float32)
    assert _bitwise(got, want)
    y = x.clone()
    _one_launch(lambda: t_ops.fault_inject_runs(
        y, ((0, 0, 0),), seed=31, ber=ber, positions=positions, fold=False,
        out=y))
    assert _bitwise(y, want)


@pytest.mark.gpu
def test_cuda_leaf_chunks_and_unstaged_table(monkeypatch):
    """A 3-chunk leaf in one launch equals the plain draw chunk by chunk
    at the folded seeds; a block of 4200 runs (beyond the 4096 the kernel
    stages in shared memory, so read from global memory) and the
    fp16 / bf16 routes equal their plain versions."""
    dev = _cuda()
    monkeypatch.setattr(t_kernel, "MAX_COUNTER_ELEMENTS", CHUNK)
    x = _stack((72, 40), seed=8)
    bits = bitops.to_bits(x)
    got = _one_launch(lambda: t_fault.draw_bits(bits.to(dev), 5, 0.05,
                                                range(16)))
    per = CHUNK // 40
    want = torch.cat([t_ref.fault_inject_ref(
        bits[r0:r0 + per], seed=fold_seed(5, c), ber=0.05,
        positions=range(16)) for c, r0 in enumerate(range(0, 72, per))])
    assert _bitwise(got.cpu(), want)
    monkeypatch.setattr(t_kernel, "MAX_COUNTER_ELEMENTS", 2 ** 27)
    big = _stack((4200, 2, 16), seed=9)
    rank = shlib.ranks_of(("data", "model"), (2, 1))[1]
    lay = shlib.layout_of(shlib.sanitize_spec(rank, (None, "data", None),
                                              big.shape), big.shape, rank)
    assert len(t_fault.layout_runs(lay)) == 4200
    blk = lay.cut(big).contiguous()
    got = _one_launch(lambda: t_fault.inject_block(3, blk.to(dev), lay, 0.1))
    assert _bitwise(got.cpu(), t_fault.inject_block(3, blk, lay, 0.1))
    for dt in (torch.float16, torch.bfloat16):
        w = x.to(dt)
        got = _one_launch(lambda: t_fault.inject(5, w.to(dev), 0.05)).cpu()
        want = t_fault.inject(5, w, 0.05)
        assert got.dtype == dt
        # bfloat16 comes back through torch's fp16 -> bf16 cast, whose NaN
        # bits differ between the CPU and the card: NaN where NaN, the rest
        # bitwise
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert _bitwise(got[~nan], want[~nan])
