"""K3's burst pass as its CUDA kernel decomposes it, emulated on the CPU.

``fault_inject_burst_tile_kernel`` (``csrc/fault_inject.cu``) has no CPU
mode. This file repeats its decomposition step by step in plain PyTorch,
with the tile geometry read from the source (``BURST_ROWS``,
``burst_cols<W>()``, ``BURST_NT``) and the launcher's clamps (``m_row =
min(m_len, R)``, ``cd = min(col_div * m_len, C)``): for each tile and
trial (a) each band's live columns in order, a band the tile's rows of one
row unit (the whole tile on the col axis), a column's unit from the tile's
first unit and its offset; (b) live element i dealt to thread i % BURST_NT
as its (i // BURST_NT)-th, a warp's threads running the same groups for
the most one of them holds, decoded by the kernel's multiply and its
band's list; (c) the copy, the words XOR the mask tile. Each tile's dealt elements
must be its live elements (the reference's per-element thresholds), each
once, and the emulated copies must equal the plain version
``ref.fault_inject_batched_ref`` bit for bit, on hypothesis-drawn planes:
uint8 / uint16 / uint32, ragged widths, tiles that do not divide the plane,
units that straddle tiles, the three axes, col_div 1, 8 and S*W. The
kernel's multiply is checked exact over every operand it can get.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import numpy as np  # noqa: E402
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro_torch.core import faultmodels as fm  # noqa: E402
from repro_torch.kernels.fault_inject import ops, ref  # noqa: E402
from repro_torch.kernels.fault_inject.kernel import seed_words  # noqa: E402

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" \
    / "fault_inject" / "csrc" / "fault_inject.cu"
M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
RATES = {"dead": 0.0, "quarter": 0.25, "half": 0.5, "live": 1.0}


def _geometry():
    """(rows a tile, {word bytes: words a tile row}, threads a block), as
    the kernel source defines them."""
    src = CU.read_text()
    rows = int(re.search(r"constexpr int BURST_ROWS = (\d+);", src).group(1))
    wide, narrow = (int(v) for v in re.search(
        r"return sizeof\(W\) == 4 \? (\d+) : (\d+);", src).groups())
    nt = int(re.search(r"constexpr int BURST_NT = (\d+);", src).group(1))
    return rows, {1: narrow, 2: narrow, 4: wide}, nt


TR, TCS, NT = _geometry()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mag(n):
    """The kernel's ``0x7FFFFFFF / n + 1``: ``__umulhi(j << 1, mag)`` is
    ``j / n``."""
    return 0x7FFFFFFF // n + 1


def _div(j, mag):
    return ((j << 1) * mag) >> 32


def emulate(bits, seeds, threshold, positions, *, m_thr, m_len, axis,
            col_div):
    """``fault_inject_burst_tile_kernel``'s copies [T, R, C] of ``bits``,
    tile by tile (module doc)."""
    r, c = bits.shape
    tc_words = TCS[bits.element_size()]
    wide = bits.to(torch.int64) & M32
    seeds = [int(s) for s in seed_words(seeds)]
    out = wide[None].repeat(len(seeds), 1, 1)
    m_row, cd = min(m_len, r), min(col_div * m_len, c)
    tiles_c = -(-c // tc_words)
    # the reference's thresholds say which elements are live
    elem = torch.arange(r * c, dtype=torch.int64).reshape(r, c)
    want_live = fm.scale_elem_thresholds(
        elem[None], threshold, torch.tensor(seeds)[:, None, None],
        kind="burst", axis=axis, m_thr=m_thr, m_len=m_len, width=c,
        col_div=col_div) != 0
    for tile in range(-(-r // TR) * tiles_c):
        tr, tc = divmod(tile, tiles_c)
        r0, c0 = tr * TR, tc * tc_words
        trv, tcv = min(TR, r - r0), min(tc_words, c - c0)
        # bands (one on the col axis) and each column's unit (row axis: none)
        ru_lo, nb = (0, 1) if axis == "col" else \
            (r0 // m_row, (r0 + trv - 1) // m_row - r0 // m_row + 1)
        rs = torch.tensor([0] + [(ru_lo + b) * m_row - r0
                                 for b in range(1, nb)] + [trv])
        assert nb <= TR
        cu_lo = 0 if axis == "row" else c0 // cd
        ucol = (c0 + torch.arange(tcv)) // cd - cu_lo
        assert int(ucol.max()) < 256                 # a byte a column
        for t, seed in enumerate(seeds):
            # (a) each band's live columns, in order
            useed = (int(fm.unit_seed(seed)) * GOLD) & M32
            lists = []
            for b in range(nb):
                row_key = 0 if axis == "col" else \
                    (ru_lo + b) * (0x10001 if axis == "bank" else 1)
                if axis == "row":
                    live = threshold != 0 and \
                        int(ref.hash_u32(row_key ^ useed)) < m_thr
                    lists.append(torch.arange(tcv) if live else
                                 torch.zeros(0, dtype=torch.int64))
                else:
                    key = (row_key + cu_lo + ucol) & M32
                    live = (ref.hash_u32(key ^ useed) < m_thr) \
                        & (threshold != 0)
                    lists.append(torch.nonzero(live).reshape(-1))
            n_b = torch.tensor([len(x) for x in lists])
            off = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum((rs[1:] - rs[:-1]) * n_b, 0)])
            total = int(off[-1])
            # (b) slot m of thread j is deal index j + m * NT; a warp runs
            # the slots of its first thread, whose count is the warp's most;
            # the slots below `total` are the live elements, each once
            tid = torch.arange(NT)
            first = tid - tid % 32
            rem = torch.where(total > first, (total - first + NT - 1) // NT,
                              torch.zeros_like(tid))
            slots = tid[:, None] + NT * torch.arange(max(int(rem.max()), 1))
            run = torch.arange(slots.shape[1])[None] < rem[:, None]
            held = ((slots < total) & run).sum(1)
            assert int(held.sum()) == total and \
                bool(((held == rem) | (held == rem - 1)).all())
            i = slots[(slots < total) & run]
            i = i.sort().values
            b = torch.searchsorted(off[1:], i, right=True)
            j = i - off[b]
            mags = torch.tensor([_mag(max(int(n), 1)) for n in n_b])
            q = _div(j, mags[b])
            assert torch.equal(q, j // n_b[b])
            flat = torch.cat(lists + [torch.zeros(0, dtype=torch.int64)])
            starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                                torch.cumsum(n_b, 0)])
            row = rs[b] + q
            col = flat[starts[b] + j - q * n_b[b]] if total else flat
            dealt = torch.zeros((trv, tcv), dtype=torch.int64)
            dealt.index_put_((row, col), torch.ones_like(row),
                             accumulate=True)
            assert torch.equal(dealt.bool(), want_live[
                t, r0:r0 + trv, c0:c0 + tcv]) and int(dealt.max()) <= 1, \
                ("tile", tile, "trial", t)
            # the draws, and (c) the copy XOR its masks
            e = (r0 + row) * c + c0 + col
            mask = torch.zeros_like(e)
            for p in positions:
                z = ((e * 32 + int(p)) & M32) ^ ((seed * GOLD) & M32)
                mask |= (ref.hash_u32(z) < threshold).to(torch.int64) << int(p)
            out[t, r0 + row, c0 + col] ^= mask
    return out.to(bits.dtype)


def _plane(eb, r, c, seed):
    words = np.random.default_rng(seed).integers(0, 2 ** (8 * eb), (r, c),
                                                 dtype=np.uint64)
    if eb == 4:
        return torch.from_numpy(words.astype(np.uint32).view(np.int32))
    return torch.from_numpy(words.astype(np.uint8 if eb == 1 else np.uint16))


def _check(eb, r, c, axis, m_len, col_div, rate, threshold, n_trials,
           positions, seed):
    bits = _plane(eb, r, c, seed)
    seeds = (np.arange(n_trials, dtype=np.uint64) * 0x9E3779B1 + seed) \
        & M32
    spec = f"burst:rate={RATES[rate]},length={m_len},axis={axis}"
    m_thr, _ = fm.model_scalars(fm.parse_fault_model(spec))
    assert m_thr == {"dead": 0, "live": M32}.get(rate, m_thr)
    want = ref.fault_inject_batched_ref(
        bits, seeds, threshold, positions=positions, m_thr=m_thr,
        m_len=m_len, model_kind="burst", model_axis=axis, col_div=col_div)
    got = emulate(bits, seeds, threshold, positions, m_thr=m_thr,
                  m_len=m_len, axis=axis, col_div=col_div)
    assert got.dtype == bits.dtype and torch.equal(got, want)
    # the entry point's plain route gives the same copies
    assert torch.equal(ops.fault_inject_bits_batched(
        bits, seeds, threshold, positions=positions, model=spec,
        col_div=col_div), want)


@st.composite
def _cases(draw):
    eb = draw(st.sampled_from((1, 2, 4)))
    geometry = draw(st.sampled_from(("plane", "col_div 8", "codeword")))
    r = draw(st.integers(1, 80))
    if geometry == "codeword":          # [B, G*S*W], col_div = S*W
        sw = draw(st.sampled_from((6, 8, 12)))
        col_div, c = sw, sw * draw(st.integers(1, 50))
    else:
        col_div, c = (1 if geometry == "plane" else 8), \
            draw(st.integers(1, 600))
    width = 8 * eb
    return dict(
        eb=eb, r=r, c=c, col_div=col_div,
        axis=draw(st.sampled_from(("row", "col", "bank"))),
        m_len=draw(st.one_of(st.integers(1, 8),
                             st.sampled_from((33, 300, 2 ** 20)))),
        rate=draw(st.sampled_from(tuple(RATES))),
        threshold=draw(st.sampled_from((0, 4294967, 128849019, M32))),
        n_trials=draw(st.integers(1, 4)),
        positions=draw(st.sampled_from((tuple(range(width)), (0, width - 1),
                                        tuple(range(1, width, 3))))),
        seed=draw(st.integers(0, M32)))


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(_cases())
@example(dict(eb=2, r=70, c=600, col_div=1, axis="row", m_len=5,
              rate="half", threshold=128849019, n_trials=4,
              positions=tuple(range(10)), seed=1))
@example(dict(eb=1, r=33, c=300, col_div=8, axis="bank", m_len=5,
              rate="quarter", threshold=M32, n_trials=2,
              positions=tuple(range(8)), seed=2))
@example(dict(eb=4, r=37, c=264, col_div=8, axis="col", m_len=3,
              rate="half", threshold=M32, n_trials=3,
              positions=tuple(range(32)), seed=3))
@example(dict(eb=2, r=40, c=77, col_div=1, axis="bank", m_len=1,
              rate="live", threshold=M32, n_trials=1,
              positions=(0, 15), seed=4))
def test_burst_tiles_emulation_matches_plain(case):
    """The tile decomposition deals every live element once and gives the
    plain version's copies bit for bit."""
    _check(**case)


@pytest.mark.parametrize("axis", ("row", "col", "bank"))
def test_burst_tiles_straddle_every_edge(axis):
    """A uint16 plane whose last row and column of tiles are ragged, with
    units that cross every tile edge (m_len 5 does not divide a tile's
    rows; col_div 3 x 5 = 15 columns does not divide its 256)."""
    _check(2, 70, 600, axis, 5, 3, "half", 128849019, 4, tuple(range(10)),
           seed=5)


def test_burst_tiles_multiplies_are_exact():
    """``__umulhi(j << 1, 0x7FFFFFFF / n + 1) == j / n`` for every n a
    band's list can hold (1 .. the widest tile row) and every j a tile's
    elements can reach."""
    j = torch.arange(TR * max(TCS.values()), dtype=torch.int64)
    for n in range(1, max(TCS.values()) + 1):
        assert torch.equal(_div(j, _mag(n)), j // n), n
