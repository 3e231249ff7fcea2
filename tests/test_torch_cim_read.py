"""The port's fused decode-on-read linear against the JAX reference kernel.

On the CPU the port's ``cim_linear_store`` takes the plain version (decode
then matmul); the reference runs its Pallas kernel in interpret mode, once
per case, with dynamic injection: the identity probe rows compare the
decoded faulted weights bit for bit, the dense rows agree within fp32
summation-order tolerance. The ``gpu`` case runs the CUDA
kernels against their plain version on a card and skips without one; it
needs no jax, so it runs on the card's machine.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.convert import store_from_numpy  # noqa: E402
from repro_torch.core import align as t_align  # noqa: E402
from repro_torch.core import cim as t_cim  # noqa: E402
from repro_torch.kernels.cim_read import ops as t_ops  # noqa: E402
from repro_torch.kernels.cim_read.ref import cim_read_ref  # noqa: E402
from repro_torch.kernels.fault_inject.ops import ber_to_threshold  # noqa: E402

try:    # the reference; the card's machine runs the gpu case without it
    import jax
    import jax.numpy as jnp
    from repro.core import align as j_align
    from repro.core import cim as j_cim
    from repro.kernels.cim_read import ops as j_ops
except ImportError:
    jax = None

SHAPES = [(5, 72, 48), (3, 264, 130), (16, 256, 128)]
TOL = 1e-5   # fp32 matmul, different summation order across frameworks


def _stores(protect, k, j, seed):
    if jax is None:
        pytest.skip("needs the JAX reference package")
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, j)) * 0.05).astype(np.float32)
    js = jax.jit(lambda a: j_cim.pack(j_align.align_matrix(
        a, j_align.AlignmentConfig())[0], j_cim.CIMConfig(protect=protect)))(
            jnp.asarray(w))
    ts = store_from_numpy({n: getattr(js, n)
                           for n in ("man", "sign", "exp", "codewords")},
                          js.shape, t_cim.CIMConfig(protect=protect))
    return js, ts, rng


def _assert_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("protect", ["one4n", "none"])
@pytest.mark.parametrize("m,k,j", SHAPES)
def test_cim_linear_store_matches_reference(protect, m, k, j):
    js, ts, rng = _stores(protect, k, j, seed=m * k + j)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jseeds = j_cim.plane_seeds(jax.random.PRNGKey(k + j))
    seeds = {n: int(v) for n, v in jseeds.items()}
    thr = int(ber_to_threshold(2e-3))
    j_sc = j_ops.make_scalars(jseeds, thr, thr)
    t_sc = t_ops.make_scalars(seeds, thr, thr)
    assert np.array_equal(np.asarray(j_sc), t_sc)

    # one reference launch: identity rows (the decoded faulted weights) and
    # dense rows, both under per-read injection
    probe = np.concatenate([np.eye(k, dtype=np.float32), x])
    j_out = np.asarray(j_ops.cim_linear_store(jnp.asarray(probe), js,
                                              scalars=j_sc))
    t_out, info = t_ops.cim_linear_store(torch.from_numpy(probe), ts,
                                         scalars=t_sc, with_info=True,
                                         device="cpu")
    assert info == {"used_kernel": False, "route": "plain"}
    t_out = t_out.numpy()
    _assert_close(j_out, t_out)
    # a column that holds an inf or NaN weight is non-finite throughout
    # (0 * inf is NaN); every other column of the probe is the weights
    injected = t_cim.inject_with_seeds(ts, seeds, thr, thr)
    t_w = t_cim.read(injected)[0].numpy()
    fin = np.isfinite(t_w).all(0)
    assert fin.mean() > 0.5
    assert np.array_equal(j_out[:k, fin].view(np.uint32),
                          t_out[:k, fin].view(np.uint32))
    assert np.array_equal(t_out[:k, fin], t_w[:, fin])

    t_dyn = t_ops.cim_linear_store(torch.from_numpy(x), ts, scalars=t_sc,
                                   device="cpu")
    t_stat = t_ops.cim_linear_store(torch.from_numpy(x), injected,
                                    device="cpu")
    assert np.array_equal(t_dyn.numpy().view(np.uint32),
                          t_stat.numpy().view(np.uint32))
    _assert_close(j_out[k:], t_dyn)


def test_per_weight_routes_to_plain_version():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((40, 24)) * 0.1).astype(np.float32))
    store = t_cim.pack(w.to(torch.float16).float(),
                       t_cim.CIMConfig(protect="per_weight"))
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    out, info = t_ops.cim_linear_store(x, store, with_info=True, device="cpu")
    assert not info["used_kernel"]
    assert torch.equal(out, x @ t_cim.read(store)[0])


def test_resolve_tiles_checks_geometry():
    w = torch.zeros((96, 32))
    tiles = t_ops.resolve_tiles(t_cim.pack(w, t_cim.CIMConfig()), 4)
    assert (tiles["block_m"], tiles["block_n"], tiles["block_k"]) == (16, 64, 64)
    assert tiles["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    with pytest.raises(NotImplementedError):
        t_ops.resolve_tiles(t_cim.pack(w, t_cim.CIMConfig(n_group=12)), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("protect", ["one4n", "none"])
def test_cuda_kernels_match_plain_version(protect):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(1)
    w = torch.randn((264, 130), generator=gen) * 0.05
    w_al, _ = t_align.align_matrix(w, t_align.AlignmentConfig())
    store = t_cim.pack(w_al.to(dev), t_cim.CIMConfig(protect=protect))
    x = torch.randn((5, 264), generator=gen).to(dev)
    out, info = t_ops.cim_linear_store(x, store, with_info=True)
    assert info["used_kernel"]
    np.testing.assert_allclose(out.cpu().numpy(),
                               cim_read_ref(x, store)[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    seeds = {"man": 1, "meta": 2, "cw": 3}
    thr = ber_to_threshold(2e-3)
    sc = t_ops.make_scalars(seeds, thr, thr)
    dyn = t_ops.cim_linear_store(x, store, scalars=sc)
    stat = t_ops.cim_linear_store(x, t_cim.inject_with_seeds(store, seeds, thr, thr))
    assert torch.equal(dyn.view(torch.int32), stat.view(torch.int32))
