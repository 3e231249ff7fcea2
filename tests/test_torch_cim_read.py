"""The port's fused decode-on-read linear against the JAX reference kernel.

On the CPU the port's ``cim_linear_store`` takes the plain version (decode
then matmul); the reference runs its Pallas kernel in interpret mode, once
per case, with dynamic injection: the identity probe rows compare the
decoded faulted weights bit for bit, the dense rows agree within fp32
summation-order tolerance. ``resolve_tiles`` picks K1's and K2's kernel by
M alone (the narrow one for M <= 8, the tile above) and is checked here
without a card. Reads under a fault process (burst, correlated, drift) hold
the injected image bitwise against the reference's. The ``gpu`` cases run
the CUDA kernels against their plain version on
a card and skip without one; they need no jax, so they run on the card's
machine.
"""
import dataclasses
import types

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


# (protect, fault process, shape): each kind and axis once on each image
MODEL_CASES = [
    ("one4n", "burst:rate=0.5,length=4,axis=row", (5, 72, 48)),
    ("one4n", "burst:rate=0.5,length=2,axis=col", (3, 264, 130)),
    ("one4n", "correlated:strength=0.8,period=4", (5, 72, 48)),
    ("none", "burst:rate=0.5,length=8,axis=bank", (3, 264, 130)),
    ("none", "correlated:strength=0.8,period=4", (5, 72, 48)),
    ("none", "drift:drift_rate=0.5,tick=3", (5, 72, 48)),
]


@pytest.mark.parametrize("protect,spec,shape", MODEL_CASES)
def test_cim_linear_store_model_matches_reference(protect, spec, shape):
    """A dynamic read under a fault process: the port's plain route against
    the reference kernel in interpret mode (``make_scalars`` with the model,
    then ``cim_linear_store(..., model=)``, which pre-scales drift): the
    injected image bitwise against the reference's, the identity rows equal
    to its decoded weights, dense rows within 1e-5, and dynamic equal to the
    static read of ``inject_with_seeds(..., model=)``."""
    from repro.core import faultmodels as j_fm
    from repro_torch.core import faultmodels as t_fm
    m, k, j = shape
    js, ts, rng = _stores(protect, k, j, seed=m * k + j + len(spec))
    x = rng.standard_normal((m, k)).astype(np.float32)
    jseeds = j_cim.plane_seeds(jax.random.PRNGKey(k + len(spec)))
    seeds = {n: int(v) for n, v in jseeds.items()}
    thr = int(ber_to_threshold(2e-2))
    jp, tp = j_fm.parse_fault_model(spec), t_fm.parse_fault_model(spec)
    j_sc = j_ops.make_scalars(jseeds, thr, thr, model=jp)
    t_sc = t_ops.make_scalars(seeds, thr, thr, model=tp)
    assert np.array_equal(np.asarray(j_sc), t_sc)
    probe = np.concatenate([np.eye(k, dtype=np.float32), x])
    j_out = np.asarray(j_ops.cim_linear_store(jnp.asarray(probe), js,
                                              scalars=j_sc, model=jp))
    t_out, info = t_ops.cim_linear_store(torch.from_numpy(probe), ts,
                                         scalars=t_sc, model=tp,
                                         with_info=True, device="cpu")
    assert not info["used_kernel"]
    t_out = t_out.numpy()
    _assert_close(j_out, t_out)
    # the image a read under the model sees: drift's tick scales the
    # thresholds, the other kinds scale per element
    t_thr = t_fm.compiled_threshold(tp, thr)
    j_img = j_cim.inject_with_seeds(js, jseeds, jnp.uint32(thr),
                                    jnp.uint32(thr), model=jp)
    t_img = t_cim.inject_with_seeds(ts, seeds, thr, thr, model=tp)
    for name in ("man", "sign", "exp", "codewords"):
        a, b = getattr(j_img, name), getattr(t_img, name)
        if a is not None:
            a = np.asarray(a)
            assert np.array_equal(a.view(np.uint32) if a.dtype == np.int32
                                  else a, b.numpy().view(a.dtype)), name
    clean = t_cim.inject_with_seeds(ts, seeds, thr, thr)
    assert not torch.equal(t_img.man, clean.man)        # the model acted
    t_w = t_cim.read(t_img)[0].numpy()
    fin = np.isfinite(t_w).all(0)
    assert np.array_equal(j_out[:k, fin].view(np.uint32),
                          t_out[:k, fin].view(np.uint32))
    assert np.array_equal(t_out[:k, fin], t_w[:, fin])
    t_dyn = t_ops.cim_linear_store(torch.from_numpy(x), ts, scalars=t_sc,
                                   model=tp, device="cpu")
    t_stat = t_ops.cim_linear_store(torch.from_numpy(x), t_img, device="cpu")
    assert np.array_equal(t_dyn.numpy().view(np.uint32),
                          t_stat.numpy().view(np.uint32))
    if tp.kind == "drift":    # the read scaled both field thresholds
        sc = t_ops.model_scalars_of(t_sc, tp)
        assert int(sc[0]) == int(sc[1]) == t_thr > thr


def test_per_weight_routes_to_plain_version():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((40, 24)) * 0.1).astype(np.float32))
    store = t_cim.pack(w.to(torch.float16).float(),
                       t_cim.CIMConfig(protect="per_weight"))
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    out, info = t_ops.cim_linear_store(x, store, with_info=True, device="cpu")
    assert not info["used_kernel"]
    assert torch.equal(out, x @ t_cim.read(store)[0])


def _unembed_geometry(cfg):
    """A stand-in store with olmo-1b's unembed planes (K = 2048, J = 50304)
    on the meta device: ``resolve_tiles`` reads only the shapes."""
    return types.SimpleNamespace(cfg=cfg, man=torch.empty(
        (2048, 50304), dtype=torch.uint16, device="meta"))


@pytest.mark.parametrize("m,kernel,m_rows", [
    (1, "narrow", 1), (4, "narrow", 4), (8, "narrow", 8), (9, "tile", None),
    (16, "tile", None)])
def test_resolve_tiles_checks_geometry(m, kernel, m_rows):
    w = torch.zeros((96, 32))
    tiles = t_ops.resolve_tiles(t_cim.pack(w, t_cim.CIMConfig()), m)
    assert tiles["kernel"] == kernel
    if kernel == "tile":
        assert (tiles["block_m"], tiles["block_n"], tiles["block_k"]) == \
            (16, 64, 64)
    else:
        assert tiles["m_rows"] == m_rows
        assert (tiles["block_n"], tiles["block_k"], tiles["stages"]) == \
            (128, 128, 4)
        assert tiles["x_slab"] == 128 and tiles["grid"] == (1,)
    assert tiles["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    # olmo-1b's unembed: all of x (K = 2048) stays in shared memory beside
    # the 4-stage ring, within the card's 227 KB, at every narrow M
    big = t_ops.resolve_tiles(_unembed_geometry(t_cim.CIMConfig()), m)
    assert big["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    if kernel == "narrow":
        assert big["x_slab"] == 2048 and big["grid"] == (393,)
    # the none image (K2) takes its narrow kernel at the same M; at the
    # unembed it too keeps all of x beside its ring
    none = t_ops.resolve_tiles(t_cim.pack(w, t_cim.CIMConfig(protect="none")),
                               m)
    assert none["kernel"] == kernel
    assert none["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    big_none = t_ops.resolve_tiles(
        _unembed_geometry(t_cim.CIMConfig(protect="none")), m)
    assert big_none["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    if kernel == "narrow":
        assert none["m_rows"] == m_rows and none["x_slab"] == 128
        assert (none["exp_stage"], none["sign_stage"]) == (2048, 2048)
        assert big_none["x_slab"] == 2048 and big_none["grid"] == (393,)
    with pytest.raises(NotImplementedError):
        t_ops.resolve_tiles(t_cim.pack(w, t_cim.CIMConfig(n_group=12)), m)


@pytest.mark.parametrize("m", [1, 4, 8, 9])
@pytest.mark.parametrize("n_group", [4, 16])
def test_resolve_tiles_none_n_group(n_group, m):
    """K2's narrow kernel tiles every power-of-two n_group dividing 128: a
    stage holds 128 / n exponent rows of 128 bytes."""
    w = torch.zeros((96, 32))
    cfg = t_cim.CIMConfig(protect="none", n_group=n_group)
    tiles = t_ops.resolve_tiles(t_cim.pack(w, cfg), m)
    assert tiles["kernel"] == ("narrow" if m <= 8 else "tile")
    assert tiles["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK
    if m <= 8:
        assert tiles["exp_stage"] == 128 // n_group * 128
        big = t_ops.resolve_tiles(_unembed_geometry(cfg), m)
        assert big["x_slab"] == 2048 and big["grid"] == (393,)
        assert big["smem_bytes"] <= t_ops.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("m", [1, 8, 16])
def test_resolve_tiles_none_refuses_n_group_12(m):
    """n_group 12 divides neither the narrow stage (128 rows) nor the tile's
    64-row chunk: the read raises instead of falling back."""
    w = torch.zeros((96, 32))
    with pytest.raises(NotImplementedError):
        t_ops.resolve_tiles(
            t_cim.pack(w, t_cim.CIMConfig(protect="none", n_group=12)), m)


def test_narrow_tables_are_the_codec_syndrome_masks():
    """The host tables the narrow kernel takes in place of per-block
    rebuilt ones: body and stored-bit masks, and syndrome column masks that
    give each single-bit error its 1-based position."""
    code = t_cim.CIMConfig().codec.code
    tables = t_ops.narrow_tables(code)
    assert tables.dtype == np.uint32 and tables.shape == (36,)
    body, hmask = tables[:4], tables[8:].reshape(7, 4)
    for i in range(code.n_body):
        word, lane = divmod(i, 32)
        assert (int(body[word]) >> lane) & 1
        syn = sum(((int(hmask[j, word]) >> lane) & 1) << j
                  for j in range(7))
        assert syn == i + 1


# ------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _identity_slices(store, m):
    """``eye(K) @ W`` through ``cim_linear_store`` in slices of ``m`` rows
    (at m <= 8 every slice takes the narrow kernel)."""
    k = store.shape[0]
    eye = torch.eye(k, device=store.device)
    return torch.cat([t_ops.cim_linear_store(eye[i:i + m], store)
                      for i in range(0, k, m)])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("protect", ["one4n", "none"])
def test_cuda_kernels_match_plain_version(protect, m):
    """A ragged store (K_log 261 < k_pad 264; J 130, not a multiple of the
    narrow kernel's 128-column strip), clean and under dynamic injection."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(1)
    w = torch.randn((261, 130), generator=gen) * 0.05
    w_al, _ = t_align.align_matrix(w, t_align.AlignmentConfig())
    store = t_cim.pack(w_al.to(dev), t_cim.CIMConfig(protect=protect))
    x = torch.randn((m, 261), generator=gen).to(dev)
    out, info = t_ops.cim_linear_store(x, store, with_info=True)
    assert info["used_kernel"]
    assert info["tiles"]["kernel"] == ("narrow" if m <= 8 else "tile")
    np.testing.assert_allclose(out.cpu().numpy(),
                               cim_read_ref(x, store)[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    seeds = {"man": 1, "meta": 2, "cw": 3}
    thr = ber_to_threshold(2e-3)
    sc = t_ops.make_scalars(seeds, thr, thr)
    dyn = t_ops.cim_linear_store(x, store, scalars=sc)
    injected = t_cim.inject_with_seeds(store, seeds, thr, thr)
    stat = t_ops.cim_linear_store(x, injected)
    assert torch.equal(dyn.view(torch.int32), stat.view(torch.int32))
    again = t_ops.cim_linear_store(x, store, scalars=sc)
    assert torch.equal(dyn.view(torch.int32), again.view(torch.int32))
    np.testing.assert_allclose(dyn.cpu().numpy(),
                               cim_read_ref(x, store, sc)[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    # the identity probe in slices of m rows: exact on every finite column,
    # non-finite throughout a column that holds an inf or NaN weight
    for image in (store, injected):
        w_ref, _ = t_cim.read(image)
        probe = _identity_slices(image, m)
        fin = torch.isfinite(w_ref).all(0)
        assert torch.equal(probe[:, fin], w_ref[:, fin])
        assert not bool(torch.isfinite(probe[:, ~fin]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("spec", [
    "burst:rate=0.5,length=4,axis=row", "burst:rate=0.5,length=4,axis=col",
    "burst:rate=0.5,length=8,axis=bank", "correlated:strength=0.8,period=4",
    "drift:drift_rate=0.5,tick=3"])
@pytest.mark.parametrize("protect", ["one4n", "none"])
def test_cuda_kernels_model_match_plain_version(protect, spec, m):
    """K1/K2 (narrow at M = 4, tile at 16) reading under a fault process:
    dynamic equals the static read of ``inject_with_seeds(..., model=)``
    bitwise, the dynamic identity probe in slices of m rows gives that
    image's weights exactly, and dense outputs agree with the plain
    version."""
    from repro_torch.core import faultmodels as t_fm
    dev = _cuda()
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((261, 130), generator=gen) * 0.05
    w_al, _ = t_align.align_matrix(w, t_align.AlignmentConfig())
    store = t_cim.pack(w_al.to(dev), t_cim.CIMConfig(protect=protect))
    x = torch.randn((m, 261), generator=gen).to(dev)
    seeds = {"man": 11, "meta": 12, "cw": 13}
    thr = ber_to_threshold(2e-2)
    model = t_fm.parse_fault_model(spec)
    sc = t_ops.make_scalars(seeds, thr, thr, model=model)
    dyn, info = t_ops.cim_linear_store(x, store, scalars=sc, model=model,
                                       with_info=True)
    assert info["tiles"]["kernel"] == ("narrow" if m <= 8 else "tile")
    thr_m = t_fm.compiled_threshold(model, thr)
    injected = t_cim.inject_with_seeds(store, seeds, thr_m, thr_m,
                                       model=dataclasses.replace(model, tick=0))
    stat = t_ops.cim_linear_store(x, injected)
    assert torch.equal(dyn.view(torch.int32), stat.view(torch.int32))
    # faulted weights reach 2^15: the dense outputs are held to 1e-4 of
    # |x| @ |W| (the bound of their summation-order error), NaN for NaN
    w_ref, _ = t_cim.read(injected)
    plain = cim_read_ref(x, store, t_ops.model_scalars_of(sc, model),
                         model)[0]
    assert torch.equal(plain.isnan(), dyn.isnan())
    fin = torch.isfinite(plain)
    scale = x.abs() @ w_ref.nan_to_num(0.0, 0.0, 0.0).abs()
    assert bool(((dyn - plain).abs()[fin] <= 1e-4 * scale[fin] + 1e-4).all())
    k = store.shape[0]
    eye = torch.eye(k, device=dev)
    probe = torch.cat([t_ops.cim_linear_store(eye[i:i + m], store,
                                              scalars=sc, model=model)
                       for i in range(0, k, m)])
    fin = torch.isfinite(w_ref).all(0)
    assert torch.equal(probe[:, fin], w_ref[:, fin])
    assert not bool(torch.isfinite(probe[:, ~fin]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("n_group", [4, 16])
def test_cuda_raw_narrow_n_group(n_group):
    """K2's narrow kernel at M = 4 where a thread's 8 rows span two block
    rows (n_group 4) or a block row spans two row groups (16): clean and
    dynamic against the plain version, dynamic == static-injected bitwise,
    and the identity probe in 4-row slices exact."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((261, 130), generator=gen) * 0.05
    cfg = t_cim.CIMConfig(protect="none", n_group=n_group)
    w_al, _ = t_align.align_matrix(w, t_align.AlignmentConfig(n_group=n_group))
    store = t_cim.pack(w_al.to(dev), cfg)
    x = torch.randn((4, 261), generator=gen).to(dev)
    out, info = t_ops.cim_linear_store(x, store, with_info=True)
    assert info["tiles"]["kernel"] == "narrow"
    np.testing.assert_allclose(out.cpu().numpy(),
                               cim_read_ref(x, store)[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    seeds = {"man": 4, "meta": 5, "cw": 6}
    thr = ber_to_threshold(2e-3)
    sc = t_ops.make_scalars(seeds, thr, thr)
    dyn = t_ops.cim_linear_store(x, store, scalars=sc)
    injected = t_cim.inject_with_seeds(store, seeds, thr, thr)
    assert torch.equal(dyn.view(torch.int32),
                       t_ops.cim_linear_store(x, injected).view(torch.int32))
    for image in (store, injected):
        w_ref, _ = t_cim.read(image)
        probe = _identity_slices(image, 4)
        fin = torch.isfinite(w_ref).all(0)
        assert torch.equal(probe[:, fin], w_ref[:, fin])
        assert not bool(torch.isfinite(probe[:, ~fin]).any())
