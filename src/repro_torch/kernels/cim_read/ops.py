"""Public wrapper of the fused decode-on-read matmul (port of
``repro/kernels/cim_read/ops.py``).

``cim_linear_store`` consumes a packed :class:`~repro_torch.core.cim.CIMStore`
directly. The route follows the tensors' device:

* a CUDA store with ``protect`` in {one4n, none} and fp16 launches the
  hand-written kernel — K1 (``cim_read_matmul_one4n``) or K2
  (``cim_read_matmul_raw``) — or raises; it never falls back. Each has two
  kernels and M alone picks one (:func:`resolve_tiles`): the narrow,
  pipelined kernel for the decode-shaped read (M <= 8), the 16 x 64 x 64
  tile above it;
* a CPU store runs the plain version (:mod:`.ref`), since no kernel runs on
  the CPU;
* ``per_weight`` / non-fp16 stores take the plain version on either device:
  that is the reference's documented route for them (``_fallback``), as no
  kernel tiles them.

``info['used_kernel']`` says whether a kernel launched, ``info['tiles']``
which kernel and geometry.

A mesh shard (a store with a :class:`~repro_torch.core.cim.ShardInfo`,
``cim.shard_store``) reads its block at global coordinates: the kernels take
its offsets in the ``SCALAR_OFF_K`` / ``SCALAR_OFF_J`` slots and the global
padded dims as ``store_k`` / ``store_j`` / ``store_g`` (the reference's
``global_dims``), and the plain version draws through the same
``ShardInfo``. :func:`cim_linear_store_sharded` combines the shards' reads
over the mesh's ``"model"`` axis.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import faultmodels as fm_lib
from repro_torch.device import resolve_device
from repro_torch.kernels.cim_read import kernel as kernel_lib
from repro_torch.kernels.cim_read import ref
from repro_torch.kernels.cim_read.ref import cim_read_ref

# The narrow kernels of K1 and K2 (M <= 8, csrc/cim_read.cu): a block owns
# a strip of NARROW_N columns and walks K through a ring of NARROW_STAGES
# shared stages of NARROW_K rows; 256 threads, each 8 columns x 8 rows a
# stage. K2's stages hold NARROW_K / n exponent rows of NARROW_N bytes and
# NARROW_K / 32 sign-word rows of NARROW_N words beside the mantissas.
NARROW_N, NARROW_K, NARROW_STAGES = 128, 128, 4
NARROW_COLS = 8
NARROW_M_ROWS = (1, 2, 4, 8)     # M is rounded up to one of these
NARROW_MAX_R = 7
# The tile kernels (M > 8): BM output rows x BN columns, walking K in
# BK-row chunks; 256 threads a block.
BLOCK_M, BLOCK_N, BLOCK_K = 16, 64, 64
MAX_CW_WORDS = 512
MAX_PAYLOAD_BITS = 512
# Shared memory a block may use on the H100 (227 KB of the SM's 256 KB).
H100_SMEM_PER_BLOCK = 232_448


def _up4(words: int) -> int:
    return -(-words // 4) * 4


def make_scalars(seeds=None, thr_man=0, thr_meta=0, off_k=0, off_j=0,
                 model=None) -> np.ndarray:
    """uint32[9] scalar vector of the fused kernels (``ref.SCALAR_*``):
    thresholds, the three plane seeds, shard offsets and the fault-model
    slots (``model``'s parameters; its kind and axis travel as launch
    arguments). Zero thresholds mean static serving."""
    seeds = seeds or {}
    m_thr, m_len = fm_lib.model_scalars(fm_lib.parse_fault_model(model))
    vals = [thr_man, thr_meta, seeds.get("man", 0), seeds.get("meta", 0),
            seeds.get("cw", 0), off_k, off_j, m_thr, m_len]
    return np.asarray([int(v) & 0xFFFFFFFF for v in vals], np.uint32)


def _narrow_tiles(store, m: int) -> dict:
    """The narrow geometry of K1 or K2 for ``m <= 8``: the strip, the stage
    ring and how many rows of x a block keeps in shared memory (all of K
    where it fits with the ring, else a slab of whole stages)."""
    m_rows = next(p for p in NARROW_M_ROWS if p >= m)
    geometry = _narrow_geometry if store.cfg.protect == "one4n" \
        else _raw_narrow_geometry
    return dict(geometry(store.cfg, *store.man.shape, m_rows))


def _fit_x(fixed: int, k_pad: int, j_pad: int, m_rows: int, **stage) -> dict:
    """The narrow geometry around a ring of ``fixed`` bytes: the rows of x
    that fit beside it, in whole stages, and the block's shared memory."""
    stages_of_x = min(-(-k_pad // NARROW_K),
                      (H100_SMEM_PER_BLOCK - fixed) // (NARROW_K * m_rows * 4))
    if stages_of_x < 1:
        raise NotImplementedError("cim_read narrow kernel: the stage ring "
                                  f"({fixed} bytes) leaves no room for x")
    x_slab = stages_of_x * NARROW_K
    smem = fixed + x_slab * m_rows * 4
    assert smem <= H100_SMEM_PER_BLOCK
    return {"kernel": "narrow", "m_rows": m_rows, "block_n": NARROW_N,
            "block_k": NARROW_K, "stages": NARROW_STAGES, **stage,
            "x_slab": x_slab, "grid": (-(-j_pad // NARROW_N),),
            "smem_bytes": smem}


# The narrow geometries are cached per store geometry, as is _one4n_args: a
# narrow read takes 0.10-0.14 ms on the card, and the host's time per call
# counts against it.
@functools.lru_cache(maxsize=None)
def _narrow_geometry(cfg, k_pad: int, j_pad: int, m_rows: int) -> dict:
    n, rw = cfg.n_group, cfg.row_weights
    codec = cfg.codec
    code = codec.code
    if NARROW_K % n or NARROW_N % rw or rw % NARROW_COLS or j_pad % 16 \
            or codec.codeword_words > 4 or code.r > NARROW_MAX_R:
        raise NotImplementedError(
            f"cim_read narrow kernel tiles n_group dividing {NARROW_K} and "
            f"row_weights a multiple of {NARROW_COLS} dividing {NARROW_N} "
            f"(got n_group={n}, row_weights={rw})")
    cb, gb = NARROW_K // n, NARROW_N // rw
    cw_stage = _up4(cb * gb * codec.n_segments * codec.codeword_words)
    pay_words = -(-codec.n_segments * codec.segment_bits // 32) + 2
    pay_buf = _up4(cb * gb * pay_words)
    fixed = NARROW_STAGES * (NARROW_K * NARROW_N * 2 + cw_stage * 4) \
        + 2 * pay_buf * 4
    return _fit_x(fixed, k_pad, j_pad, m_rows)


@functools.lru_cache(maxsize=None)
def _raw_narrow_geometry(cfg, k_pad: int, j_pad: int, m_rows: int) -> dict:
    n = cfg.n_group
    if NARROW_K % n or j_pad % 16 or cfg.fmt.name != "fp16":
        raise NotImplementedError(
            f"cim_read narrow kernel (none) tiles fp16 with n_group a power "
            f"of two dividing {NARROW_K} (got n_group={n}, {cfg.fmt.name})")
    exp_stage = NARROW_K // n * NARROW_N
    sign_stage = NARROW_K // 32 * NARROW_N * 4
    fixed = NARROW_STAGES * (NARROW_K * NARROW_N * 2 + sign_stage + exp_stage)
    return _fit_x(fixed, k_pad, j_pad, m_rows, exp_stage=exp_stage,
                  sign_stage=sign_stage)


def resolve_tiles(store, m: int) -> dict:
    """The kernel and its geometry for one store and ``m`` rows of x. M
    alone picks the kernel: a one4n or none store read with ``m <= 8`` gets
    K1's or K2's narrow kernel (``kernel='narrow'``), any other read the
    fixed tile (``kernel='tile'``). The geometry is checked against the
    store's layout quanta and the card's shared memory; the tile's
    ``BLOCK_N`` must hold whole ``row_weights`` groups, ``BLOCK_K`` whole
    exponent blocks (and whole 32-row sign words for ``protect='none'``).
    The reference budgets 8 MiB of TPU VMEM for a full-K strip; a Hopper
    block has 227 KB, so the kernels walk K in chunks instead. Raises
    ``NotImplementedError`` for a geometry the kernel does not tile."""
    cfg = store.cfg
    if cfg.protect in ("one4n", "none") and m <= NARROW_M_ROWS[-1]:
        return _narrow_tiles(store, m)
    n, rw = cfg.n_group, cfg.row_weights
    k_pad, j_pad = store.man.shape
    if BLOCK_K % n or BLOCK_N % rw or j_pad % 16:
        raise NotImplementedError(
            f"cim_read kernels tile n_group dividing {BLOCK_K} and row_weights "
            f"dividing {BLOCK_N} (got n_group={n}, row_weights={rw})")
    smem = BLOCK_M * BLOCK_K * 4 + BLOCK_K * BLOCK_N * 5     # x, w, exponents
    if cfg.protect == "one4n":
        codec = cfg.codec
        cw_words = (BLOCK_K // n) * (BLOCK_N // rw) * codec.n_segments \
            * codec.codeword_words
        if cw_words > MAX_CW_WORDS or codec.payload_bits > MAX_PAYLOAD_BITS \
                or codec.codeword_words > 4:
            raise NotImplementedError(
                f"cim_read one4n kernel: codeword geometry too large "
                f"({cw_words} words, {codec.payload_bits} payload bits a chunk)")
        smem += MAX_CW_WORDS * 4 + MAX_PAYLOAD_BITS * 2 + 8 * 4 * 4
    else:
        smem += (BLOCK_K // 32) * BLOCK_N * 4
    assert smem <= H100_SMEM_PER_BLOCK
    return {"kernel": "tile", "block_m": BLOCK_M, "block_n": BLOCK_N,
            "block_k": BLOCK_K,
            "grid": (-(-j_pad // BLOCK_N), -(-max(m, 1) // BLOCK_M)),
            "smem_bytes": smem}


def narrow_tables(code) -> np.ndarray:
    """uint32 [36] codeword tables of the narrow kernel for a SECDED
    ``code``, padded to 4 words a row: each codeword word's body mask and
    stored-bit mask, then the syndrome column masks [7, 4]
    (:attr:`~repro_torch.core.ecc.SecdedCode.syndrome_masks`)."""
    syn = code.syndrome_masks
    hmask = np.zeros((NARROW_MAX_R, 4), np.uint32)
    hmask[:syn.shape[0], :syn.shape[1]] = syn
    return np.concatenate([bitpack.word_masks(code.n_body, 4),
                           bitpack.word_masks(code.n, 4), hmask.ravel()])


@functools.lru_cache(maxsize=None)
def _one4n_args(cfg) -> dict:
    """The codeword geometry and host tables K1's kernels take."""
    codec = cfg.codec
    code = codec.code
    return dict(row_weights=cfg.row_weights, n_segments=codec.n_segments,
                code_words=codec.codeword_words,
                segment_bits=codec.segment_bits, n_body=code.n_body, r=code.r,
                payload_bits=codec.payload_bits, tables=narrow_tables(code),
                word_masks=np.concatenate([bitpack.word_masks(code.n_body, 4),
                                           bitpack.word_masks(code.n, 4)]))


_STATIC = make_scalars()


def _global_pad(store) -> tuple:
    """(K_pad, J_pad) of the image a store's planes index: its own, or its
    shard's global image."""
    sh = store.shard
    return tuple(sh.global_pad) if sh is not None and sh.sharded \
        else tuple(store.man.shape)


def _with_offsets(scalars, store):
    """``scalars`` with the store's shard offsets in their slots (a copy;
    ``None`` stays ``None``). Offsets that a caller set must agree."""
    sh = store.shard
    if sh is None or not sh.sharded:
        off = (0, 0)
    else:
        off = sh.offsets
    if scalars is None:
        return None
    got = (int(scalars[ref.SCALAR_OFF_K]), int(scalars[ref.SCALAR_OFF_J]))
    if any(got) and got != off:
        raise ValueError(f"cim_linear_store: scalars carry shard offsets "
                         f"{got}, the store's ShardInfo {off}")
    sc = np.array(scalars, dtype=np.uint32)
    sc[ref.SCALAR_OFF_K], sc[ref.SCALAR_OFF_J] = off
    return sc


def _kernel_call(x2: torch.Tensor, store, scalars, tiles: dict,
                 model=None) -> torch.Tensor:
    cfg = store.cfg
    k_log, j_log = store.shape
    # a shard's draws index the global image (the reference's global_dims)
    k_pad, j_pad = _global_pad(store)
    dynamic = scalars is not None
    sc = scalars if dynamic else _STATIC
    fmt = cfg.fmt
    kind = model.kind if dynamic and model is not None else "iid"
    axis = model.axis if dynamic and model is not None else "row"
    common = dict(k_log=k_log, n_out=j_log, n_group=cfg.n_group,
                  man_bits=fmt.man_bits, exp_bits=fmt.exp_bits, bias=fmt.bias,
                  store_j=j_pad, dynamic=dynamic, model_kind=kind,
                  model_axis=axis)
    if cfg.protect == "one4n":
        one4n = dict(_one4n_args(cfg), store_g=j_pad // cfg.row_weights)
        tables, payload_bits = one4n.pop("tables"), one4n.pop("payload_bits")
        word_masks = one4n.pop("word_masks")
        if tiles["kernel"] == "narrow":
            return kernel_lib.cim_read_matmul_one4n_narrow(
                x2, store.man, store.codewords, sc, tables=tables,
                x_slab=tiles["x_slab"], smem_bytes=tiles["smem_bytes"],
                **one4n, **common)
        return kernel_lib.cim_read_matmul_one4n(
            x2, store.man, store.codewords, sc, payload_bits=payload_bits,
            word_masks=word_masks, **one4n, **common)
    if tiles["kernel"] == "narrow":
        return kernel_lib.cim_read_matmul_raw_narrow(
            x2, store.man, store.exp, store.sign, sc, store_k=k_pad,
            x_slab=tiles["x_slab"], smem_bytes=tiles["smem_bytes"], **common)
    return kernel_lib.cim_read_matmul_raw(
        x2, store.man, store.exp, store.sign, sc, store_k=k_pad, **common)


def _check_planes(store, dev: torch.device) -> None:
    for name in ("man", "sign", "exp", "codewords"):
        p = getattr(store, name)
        if p is None:
            continue
        if p.device != dev:
            raise ValueError(f"cim_linear_store: store.{name} is on {p.device}, "
                             f"expected {dev}")
        if not p.is_contiguous():
            raise ValueError(f"cim_linear_store: store.{name} must be "
                             f"contiguous")


def model_scalars_of(scalars, model):
    """The dynamic ``scalars`` of a read under ``model``: its parameters in
    the ``SCALAR_M_*`` slots and, for drift, the field thresholds scaled by
    its static tick (element-independent, so once on the host). A copy;
    ``None`` leaves the vector as it is."""
    if model is None:
        return scalars
    sc = np.array(scalars, dtype=np.uint32)
    sc[ref.SCALAR_M_THR], sc[ref.SCALAR_M_LEN] = fm_lib.model_scalars(model)
    if model.kind == "drift":
        for slot in (ref.SCALAR_THR_MAN, ref.SCALAR_THR_META):
            sc[slot] = fm_lib.compiled_threshold(model, int(sc[slot]))
    return sc


def cim_linear_store(x: torch.Tensor, store, *, scalars=None, model=None,
                     with_info: bool = False, device=None):
    """Fused linear layer on a packed CIM store: ``x [..., K] -> [..., J]``.

    ``scalars=None`` serves the image as stored. Per-read dynamic injection
    passes ``make_scalars(seeds, thr_man, thr_meta)``: the kernel then draws
    the :func:`repro_torch.core.cim.inject_with_seeds` flip streams on the
    words it loads, before decoding. ``model`` (a fault process or its
    grammar string) shapes a dynamic read's flips: burst and correlated
    thresholds are computed per element in the kernel (kind and axis as
    launch arguments, parameters in the ``SCALAR_M_*`` slots); a drift
    model's static tick scales the field thresholds here. The streams equal
    ``cim.inject_with_seeds(..., model=model)`` at the same seeds.
    ``device`` (default ``cuda``) names where ``x`` and the store must lie;
    a ``cuda`` request with no card raises. Returns the output, or ``(out,
    info)`` with ``with_info``."""
    dev = resolve_device(device)
    if x.device != dev:
        raise ValueError(f"cim_linear_store: x is on {x.device}, expected {dev}")
    _check_planes(store, dev)
    model = fm_lib.parse_fault_model(model)
    cfg = store.cfg
    k_log, j_log = store.shape
    b_shape = x.shape[:-1]
    if x.shape[-1] != k_log:
        raise ValueError(f"cim_linear_store: x has K={x.shape[-1]}, store "
                         f"{store.shape}")
    x2 = x.reshape(-1, k_log).to(torch.float32).contiguous()
    if scalars is not None:
        scalars = model_scalars_of(_with_offsets(scalars, store), model)

    kernel_route = cfg.protect in ("one4n", "none") and cfg.fmt.name == "fp16"
    if kernel_route and dev.type == "cuda":
        tiles = resolve_tiles(store, x2.shape[0])
        out = _kernel_call(x2, store, scalars, tiles, model)
        info = {"used_kernel": True, "route": "kernel", "tiles": tiles}
    else:
        out, _ = cim_read_ref(x2, store, scalars, model=model)
        info = {"used_kernel": False, "route": "plain"}
    out = out.reshape(*b_shape, j_log)
    return (out, info) if with_info else out


def sharded_route(store, n_shards: int, dim: str = "j") -> bool:
    """Whether a read of ``store`` split ``n_shards`` ways along ``dim``
    goes through the sharded kernel route: the reference's rule (a one4n
    or none fp16 store, planes that split evenly, and for ``'k'`` no
    padded word lines, since a K shard must hold whole slabs of x). Other
    stores are read whole on every rank (``sharded=False``)."""
    from repro_torch.core import cim as cim_lib
    cfg = store.cfg
    k_log = store.shape[0]
    return cfg.protect in ("one4n", "none") and cfg.fmt.name == "fp16" \
        and cim_lib.can_shard_store(store, n_shards, dim) \
        and (dim == "j" or k_log == store.man.shape[0])


def cim_linear_store_sharded(x: torch.Tensor, store, *, scalars=None,
                             model=None, mesh=None, with_info: bool = False,
                             device=None):
    """Mesh-sharded fused linear layer: each rank on the ``"model"`` axis of
    ``mesh`` (default: the ambient mesh, ``distributed.sharding.get_mesh``)
    reads only ITS block of the packed image, at its global offsets, and
    the blocks are combined:

    * ``dim='j'``: the rank's [M, J/n] output slice; the slices are
      all-gathered over the axis (each column's K loop is the unsharded
      one's, so the result is the unsharded kernel's, bit for bit);
    * ``dim='k'``: the rank contracts its K slab of ``x``; the partial
      products are all-reduced (another summation order: fp32 tolerance).

    ``store`` is the rank's placed shard (``deployment.place_stores``, the
    one placement rule; a store without a ``ShardInfo`` raises). A store
    the route does not take (:func:`sharded_route`: per_weight, non-fp16,
    uneven planes, a K shard over padded rows) was placed whole: every rank
    reads it whole and ``info['sharded']`` is False, the reference's rule.
    Each rank's x holds its own batch rows: the data axis splits requests,
    not this read."""
    from repro_torch.distributed import sharding as shlib
    axis = shlib.MODEL_AXIS
    mesh = mesh if mesh is not None else shlib.get_mesh()
    if mesh is None or axis not in shlib.axis_names(mesh):
        raise ValueError(f"cim_linear_store_sharded: no mesh with a "
                         f"{axis!r} axis (pass mesh= or set_mesh)")
    sh = store.shard
    if sh is None:
        raise ValueError("cim_linear_store_sharded: the store is not placed "
                         "(deployment.place_stores)")
    if not sh.sharded:
        out = cim_linear_store(x, store, scalars=scalars, model=model,
                               with_info=with_info, device=device)
        if with_info:
            out, info = out
            return out, dict(info, sharded=False)
        return out
    k_glob, j_glob = sh.global_shape
    if sh.dim == "k":
        off_k = sh.offsets[0]
        x = x[..., off_k:off_k + store.shape[0]]
    out = cim_linear_store(x, store, scalars=scalars, model=model,
                           with_info=with_info, device=device)
    info = None
    if with_info:
        out, info = out
    if sh.dim == "j":
        out = shlib.all_gather_cat(out, axis, mesh, dim=-1)[..., :j_glob]
    else:
        out = shlib.all_reduce_sum(out, axis, mesh)
    if with_info:
        return out, dict(info, sharded=True)
    return out

