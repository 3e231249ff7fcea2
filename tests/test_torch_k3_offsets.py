"""K3 at column-shard offsets: a column block of a plane drawn at its global
counters.

A 2-D sweep mesh column-shards every store over ``"model"``; each rank's K3
launch draws its block ``[R, C]`` as columns ``col_off .. col_off + C - 1``
of the ``[R, global_cols]`` plane: element (r, c) at counter ``r *
global_cols + col_off + c``, under the global plane's process geometry. The
plain version at a placement must equal the matching columns of the
unsharded plain draw, for every process, shard widths that cut banks,
burst units and 32-word lanes, ``col_div`` > 1 and uint8 / uint16 / uint32
planes; the entry point routes a ``ShardInfo`` and checks the global
counter space. The ``gpu`` cases hold the kernel to the plain version and
to the unsharded kernel's block.
"""
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import numpy as np  # noqa: E402
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro_torch.core import cim as cim_lib  # noqa: E402
from repro_torch.kernels.fault_inject import kernel, ops  # noqa: E402

SPECS = ("iid", "drift:drift_rate=0.5,tick=3",
         "correlated:strength=0.9,period=3",
         "burst:rate=0.5,length=3,axis=row",
         "burst:rate=0.5,length=5,axis=col",
         "burst:rate=0.5,length=2,axis=bank")
DTYPES = {1: (torch.uint8, range(8)), 2: (torch.uint16, range(16)),
          4: (torch.int32, range(32))}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(rows, cols, nbytes, seed):
    words = np.random.default_rng(seed).integers(0, 2 ** (8 * nbytes),
                                                 (rows, cols), np.uint64)
    dtype = DTYPES[nbytes][0]
    if nbytes == 4:
        return torch.from_numpy(words.astype(np.uint32).view(np.int32))
    if nbytes == 2:
        return torch.from_numpy(words.astype(np.uint16).view(np.int16)) \
            .view(torch.uint16)
    return torch.from_numpy(words.astype(np.uint8)).to(dtype)


def _draw(bits, seeds, spec, col_div, at=None, **kw):
    return ops.fault_inject_bits_batched(
        bits, seeds, ops.ber_to_threshold(0.08),
        positions=DTYPES[bits.element_size()][1], model=spec,
        col_div=col_div, at=at, **kw)


@settings(max_examples=40, deadline=None)
@given(rows=st.integers(1, 19), width=st.integers(1, 45),
       n_shards=st.integers(2, 4), nbytes=st.sampled_from([1, 2, 4]),
       spec=st.sampled_from(SPECS), col_div=st.sampled_from([1, 3, 8]),
       seed=st.integers(0, 2 ** 32 - 1))
@example(rows=5, width=37, n_shards=3, nbytes=2,
         spec="burst:rate=0.5,length=2,axis=bank", col_div=3, seed=7)
def test_plain_at_offsets_equals_unsharded_columns(rows, width, n_shards,
                                                   nbytes, spec, col_div,
                                                   seed):
    """Each shard's plain draw is its columns of the unsharded draw."""
    bits = _plane(rows, width * n_shards, nbytes, seed)
    seeds = np.asarray([seed, seed ^ 0x5A5A5A5A], np.uint32)
    whole = _draw(bits, seeds, spec, col_div)
    for i in range(n_shards):
        cols = slice(i * width, (i + 1) * width)
        got = _draw(bits[:, cols].contiguous(), seeds, spec, col_div,
                    at=(i * width, width * n_shards))
        assert torch.equal(got, whole[:, :, cols]), (i, spec)


@pytest.mark.parametrize("protect", ["one4n", "none"])
def test_shard_info_routes_each_plane(protect):
    """A store's planes placed by its ``ShardInfo`` draw their blocks of the
    whole store's planes; the flattened codeword plane too (``col_div`` =
    S*W, shards that cut column groups' words)."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (24, 96)).astype(np.float32))
    store = cim_lib.pack(w, cim_lib.CIMConfig(protect=protect))
    seeds = np.asarray([11, 0xDEADBEEF, 5], np.uint32)
    spec = "burst:rate=0.5,length=2,axis=col"
    planes = {"man": (store.man, 1)}
    if store.codewords is not None:
        cw = store.codewords
        planes["cw"] = (cw.reshape(cw.shape[0], -1), cw.shape[2] * cw.shape[3])
    else:
        planes["exp"], planes["sign"] = (store.exp, 1), (store.sign, 1)
    n = 3
    shards = [cim_lib.shard_store(store, n, i, "j") for i in range(n)]
    assert all(s.shard.sharded for s in shards)
    for name, (plane, col_div) in planes.items():
        whole = _draw(plane, seeds, spec, col_div)
        width = plane.shape[1] // n
        for i, sh in enumerate(shards):
            local = cim_lib.plane_dict(sh)[name]
            local = local.reshape(local.shape[0], -1)
            got = _draw(local, seeds, spec, col_div, at=sh.shard, plane=name)
            assert torch.equal(got, whole[:, :, i * width:(i + 1) * width]), \
                (name, i)


def test_placement_refusals_and_global_counter_space():
    """A K shard has no column placement; a block must lie in its plane; the
    counter space checked is the global plane's, not the block's."""
    w = torch.ones(64, 32)
    store = cim_lib.pack(w, cim_lib.CIMConfig(protect="none"))
    k_shard = cim_lib.shard_store(store, 2, 1, "k")
    with pytest.raises(NotImplementedError, match="dim='k'"):
        _draw(k_shard.man, [1], "iid", 1, at=k_shard.shard, plane="man")
    whole = cim_lib.shard_store(store, 3, 1, "j")      # 32 does not split
    assert not whole.shard.sharded
    assert torch.equal(_draw(store.man, [1], "iid", 1, at=whole.shard,
                             plane="man"), _draw(store.man, [1], "iid", 1))
    bits = _plane(2, 4, 2, 0)
    with pytest.raises(ValueError, match="leaves its"):
        _draw(bits, [1], "iid", 1, at=(5, 8))
    with pytest.raises(ValueError, match="counter space"):
        _draw(bits, [1], "iid", 1,
              at=(0, kernel.MAX_COUNTER_ELEMENTS // 2 + 1))
    with pytest.raises(ValueError, match="not 1/3"):
        ops.placement(cim_lib.shard_store(
            cim_lib.pack(torch.ones(8, 96), cim_lib.CIMConfig()), 3, 0, "j")
            .shard, 7, "man")


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_cuda_k3_at_offsets(spec, nbytes):
    """The kernel at offsets: bitwise its plain version and the unsharded
    kernel's block, one K3 launch a shard (16-byte and one-word chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    seeds = np.asarray([1, 0xDEADBEEF, 77], np.uint32)
    for rows, width, n, col_div in ((33, 48, 4, 3), (7, 37, 3, 8)):
        bits = _plane(rows, width * n, nbytes, rows)
        whole = _draw(bits.to(dev), seeds, spec, col_div).cpu()
        for i in range(n):
            cols = slice(i * width, (i + 1) * width)
            block = bits[:, cols].contiguous()
            before = kernel.launch_counts[kernel.K3]
            got = _draw(block.to(dev), seeds, spec, col_div,
                        at=(i * width, width * n)).cpu()
            assert kernel.launch_counts[kernel.K3] == before + 1
            want = _draw(block, seeds, spec, col_div,
                         at=(i * width, width * n))
            assert torch.equal(got, want), (spec, i)
            assert torch.equal(got, whole[:, :, cols]), (spec, i)

