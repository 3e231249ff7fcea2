"""Bit-accurate emulation of the Unicorn-CIM weight memory (port of
``repro/core/cim.py``, paper Fig. 3/4).

A :class:`CIMStore` holds one [K, J] weight matrix as word-packed planes:

* ``man``: uint16 [K_pad, J_pad] mantissas;
* ``protect='one4n'``: ``codewords`` int32 [B, G, n_seg, W] — the uint32
  words of each block row's SECDED-coded exponent + sign payload;
* ``protect='per_weight'``: ``codewords`` uint16 [K_pad, J_pad], one
  SECDED(6) word per weight;
* ``protect='none'``: ``exp`` uint8 [B, J_pad] shared exponents plus a
  K-packed ``sign`` plane int32 [ceil(K_pad/32), J_pad].

Every plane keeps its storage width, so ``stored_bytes`` equals the
reference's. Fault injection follows the counter-PRNG contract: bit ``p`` of
the word at C-order flat index ``e`` flips iff
``hash_u32((e*32 + p) ^ seed*0x9E3779B9) < threshold``.

Seeds are explicit uint32 per-plane dicts ``{"man", "meta", "cw"}`` (Python
ints). The reference derives them from a ``jax.random`` key
(``cim.plane_seeds``); the port does not reimplement threefry, so a caller
that wants the reference's streams passes the reference's seeds.

Mesh shards. :func:`shard_store` cuts a store into ``n_shards`` blocks along
``dim`` (``'j'``: output columns in whole ``row_weights`` groups; ``'k'``:
word lines in whole exponent blocks and sign words) and returns block
``index`` as a store whose :class:`ShardInfo` records the global image. Every
function of a store honours it: :func:`inject_with_seeds` (and so
:func:`inject` / :func:`inject_sharded`) draws each local word at its GLOBAL
C-order index, the fault processes compile against the global plane shapes,
and :func:`read_rows` decodes a column block at global coordinates, so each
shard's flips equal the single-device image's block bit for bit. Reads and
ECC counts of a shard are local; the combine over a mesh (gather the column
blocks, sum the K slabs and the counts) is the caller's
(:mod:`repro_torch.core.deployment`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import align as align_lib
from repro_torch.core import bitops, bitpack
from repro_torch.core import faultmodels as fm
from repro_torch.core import tree
from repro_torch.core.bitops import FP16, FloatFormat
from repro_torch.core.ecc import One4NRowCodec, SecdedCode
from repro_torch.kernels.fault_inject.ops import ber_to_threshold, hash_u32

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
PROTECTS = ("one4n", "per_weight", "none")


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    n_group: int = 8
    index: int = 2
    protect: str = "one4n"      # 'one4n' | 'per_weight' | 'none'
    fmt: FloatFormat = FP16
    row_weights: int = 16

    @property
    def codec(self) -> One4NRowCodec:
        return One4NRowCodec(n_group=self.n_group, row_weights=self.row_weights,
                             exp_bits=self.fmt.exp_bits,
                             sign_bits_per_row=self.row_weights)

    @property
    def pw_code(self) -> SecdedCode:
        return SecdedCode(self.fmt.exp_bits + 1)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Where a store's planes sit in the image they were cut from.

    ``sharded`` False means the planes did not split evenly and the shard
    holds the whole image (replicated, as the reference's placement
    degrades). ``global_shape`` is the logical (K, J), ``global_pad`` the
    padded (K_pad, J_pad), ``plane_shapes`` each plane's global shape."""

    n_shards: int
    index: int
    dim: str
    sharded: bool
    global_shape: Tuple[int, int]
    global_pad: Tuple[int, int]
    plane_shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @property
    def sdim(self) -> int:
        """The plane dimension that is split: 0 for ``'k'``, 1 for ``'j'``."""
        return 0 if self.dim == "k" else 1

    def plane_shape(self, name: str) -> Tuple[int, ...]:
        return dict(self.plane_shapes)[name]

    @property
    def offsets(self) -> Tuple[int, int]:
        """(off_k, off_j): the shard's first weight row and column."""
        if not self.sharded:
            return 0, 0
        k_pad, j_pad = self.global_pad
        if self.dim == "k":
            return self.index * (k_pad // self.n_shards), 0
        return 0, self.index * (j_pad // self.n_shards)


@dataclasses.dataclass
class CIMStore:
    """Word-packed SRAM image of one [K, J] weight matrix (see module doc).

    ``cache`` is the serving-only decoded fp32 matrix (``read(store)[0]``),
    not part of the SRAM image or its accounting. ``shard`` (None for a
    whole image) places a mesh shard's block in its global image; its
    ``shape`` is then the block's logical shape."""

    man: torch.Tensor
    sign: Optional[torch.Tensor]
    exp: Optional[torch.Tensor]
    codewords: Optional[torch.Tensor]
    shape: Tuple[int, int]
    cfg: CIMConfig
    cache: Optional[torch.Tensor] = None
    shard: Optional[ShardInfo] = None

    @property
    def device(self) -> torch.device:
        return self.man.device

    @property
    def stored_bits(self) -> int:
        """Logical SRAM cells: codewords count ``code.n`` bits each and each
        protected sign bit once (inside its codeword)."""
        n = self.man.numel() * self.cfg.fmt.man_bits
        if self.codewords is not None:
            if self.cfg.protect == "per_weight":
                n += self.codewords.numel() * self.cfg.pw_code.n
            else:
                n_cw = int(np.prod(self.codewords.shape[:-1]))
                n += n_cw * self.cfg.codec.code.n
        else:
            n += self.exp.numel() * self.cfg.fmt.exp_bits
            n += self.man.numel()
        return n

    @property
    def stored_bytes(self) -> int:
        """Container bytes of every plane."""
        planes = [self.man, self.sign, self.exp, self.codewords]
        return sum(p.numel() * p.element_size() for p in planes if p is not None)


def _pad_to(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, j - x.shape[1], 0, k - x.shape[0]))


def pack_sign_plane(sign_bits: torch.Tensor) -> torch.Tensor:
    """Sign bit plane [K, J] {0,1} -> K-packed int32 words [ceil(K/32), J]."""
    k, j = sign_bits.shape
    sw = bitpack.n_words(k)
    padded = torch.nn.functional.pad(sign_bits.to(torch.int64),
                                     (0, 0, 0, sw * 32 - k))
    shifts = torch.arange(32, dtype=torch.int64, device=sign_bits.device)
    words = (padded.reshape(sw, 32, j) << shifts[None, :, None]).sum(1)
    return bitpack.narrow_u32(words)


def unpack_sign_plane(sign_words: torch.Tensor, k: int) -> torch.Tensor:
    """K-packed words [SW, J] -> sign bit plane [k, J] uint8."""
    sw, j = sign_words.shape
    shifts = torch.arange(32, dtype=torch.int64, device=sign_words.device)
    bits = (bitpack.widen(sign_words)[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(sw * 32, j)[:k].to(torch.uint8)


def pack(w: torch.Tensor, cfg: CIMConfig) -> CIMStore:
    """Pack an exponent-aligned [K, J] weight matrix into its SRAM image (the
    shared exponent is the block max, exact for aligned input)."""
    if w.ndim != 2:
        raise ValueError("pack() operates on 2-D [in, out] matrices")
    if cfg.protect not in PROTECTS:
        raise ValueError(f"protect={cfg.protect!r}; expected one of {PROTECTS}")
    k, j = w.shape
    n, rw = cfg.n_group, cfg.row_weights
    k_pad = math.ceil(k / n) * n
    j_pad = math.ceil(j / rw) * rw
    b, g = k_pad // n, j_pad // rw

    s, e, m = bitops.split_fields(w.to(torch.float32), cfg.fmt)
    s, e, m = (_pad_to(t, k_pad, j_pad) for t in (s, e, m))
    e_block = e.reshape(b, n, j_pad).amax(dim=1)                 # [B, J_pad]
    sign = exp = codewords = None
    if cfg.protect == "one4n":
        codec = cfg.codec
        exp_rows = e_block.reshape(b, g, rw)
        signs = s.reshape(b, n, g, rw).permute(0, 2, 1, 3)
        codewords = bitpack.narrow_u32(
            codec.encode_packed(exp_rows, codec.pack_signs(signs)))
    elif cfg.protect == "per_weight":
        data = (e | (s << cfg.fmt.exp_bits))[..., None]
        codewords = cfg.pw_code.encode_packed(data)[..., 0].to(torch.uint16)
    else:
        sign = pack_sign_plane(s)
        exp = e_block.to(torch.uint8)
    return CIMStore(man=m.to(torch.uint16), sign=sign, exp=exp,
                    codewords=codewords, shape=(k, j), cfg=cfg)


# ---------------------------------------------------------------------------
# Counter-PRNG fault injection on packed words.
# ---------------------------------------------------------------------------


def fold_seed(seed: int, i: int) -> int:
    """Decorrelate a plane seed per read index (dynamic injection streams)."""
    salt = (int(i) * 0x85EBCA6B + GOLD) & M32
    return hash_u32((int(seed) & M32) ^ salt)


def _flip_gathered(words: torch.Tensor, elem: torch.Tensor, seed: int,
                   threshold: int, valid) -> torch.Tensor:
    """Counter-PRNG flips of ``words`` at flat store indices ``elem``.

    ``valid`` is a lane mask: an int or numpy array (only its set lanes are
    drawn) or a tensor (all 32 lanes drawn, then masked). ``threshold`` is
    an int or an int64 tensor of per-element thresholds (a compiled fault
    process, :func:`faultmodels.plane_thresholds`)."""
    if not isinstance(threshold, torch.Tensor):
        threshold = int(threshold)
        if threshold == 0:
            return words
    if isinstance(valid, torch.Tensor):
        union = M32
        vmask = valid.to(torch.int64)
    else:
        valid = np.asarray(valid, np.uint32)
        union = int(np.bitwise_or.reduce(valid.ravel())) if valid.ndim \
            else int(valid)
        vmask = torch.as_tensor(valid.astype(np.int64), device=words.device)
    seed_mul = (int(seed) * GOLD) & M32
    base = (elem.to(torch.int64) * 32) & M32
    mask = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    for p in range(32):
        if (union >> p) & 1:
            z = ((base + p) & M32) ^ seed_mul
            mask |= (hash_u32(z) < threshold).to(torch.int64) << p
    mask = mask & vmask
    return (bitpack.widen(words) ^ mask).to(words.dtype)


def _rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]``; uint16 planes gather through their int16 view (CUDA
    has no uint16 indexing kernel)."""
    if plane.dtype == torch.uint16:
        return plane.view(torch.int16)[idx].view(torch.uint16)
    return plane[idx]


def _elem(shape, device) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def global_elem(local_shape, global_shape, sdim: int, start: int,
                device) -> torch.Tensor:
    """C-order flat indices into the GLOBAL plane of ``global_shape`` for a
    local block of ``local_shape`` whose dimension ``sdim`` starts at
    ``start`` (the reference's ``_global_elem``)."""
    elem = torch.zeros(local_shape, dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(global_shape))):
        shape = [1] * len(local_shape)
        shape[d] = local_shape[d]
        idx = torch.arange(local_shape[d], dtype=torch.int64,
                           device=device).reshape(shape)
        if d == sdim:
            idx = idx + int(start)
        elem = elem + idx * stride
        stride *= int(global_shape[d])
    return elem


def _plane_elem(store: CIMStore, name: str, words: torch.Tensor):
    """(flat element indices, global plane shape) of one of ``store``'s
    planes: its own C-order indices, or a shard block's global ones."""
    sh = store.shard
    if sh is None or not sh.sharded:
        return _elem(words.shape, words.device), tuple(words.shape)
    gshape = sh.plane_shape(name)
    start = sh.index * words.shape[sh.sdim]
    return (global_elem(words.shape, gshape, sh.sdim, start, words.device),
            gshape)


def counter_flip_words(words: torch.Tensor, seed: int, threshold, valid,
                       model=None, elem=None, shape=None) -> torch.Tensor:
    """Flip bits of a packed word plane per the counter-PRNG contract, at
    flat indices ``elem`` of a plane of ``shape`` (default: the plane's
    own)."""
    if elem is None:
        elem, shape = _elem(words.shape, words.device), words.shape
    threshold = fm.plane_thresholds(model, threshold, elem, seed, shape)
    return _flip_gathered(words, elem, seed, threshold, valid)


def codeword_valid_masks(cfg: CIMConfig) -> np.ndarray:
    """Per-word stored-bit masks of the active codeword plane."""
    if cfg.protect == "per_weight":
        return np.asarray(bitpack.word_masks(cfg.pw_code.n)[0], np.uint32)
    return cfg.codec.code.code_word_masks


def inject_with_seeds(store: CIMStore, seeds: dict, thr_man, thr_meta,
                      model=None) -> CIMStore:
    """Flip stored bits from explicit per-plane seeds + field thresholds
    (``thr_man`` gates mantissa cells, ``thr_meta`` exponent/sign/check
    cells; zero leaves a field untouched). ``model`` is a fault process or
    its grammar string. A shard draws at its global indices (module doc)."""
    cfg = store.cfg
    model = fm.parse_fault_model(model)

    def flip(name, words, seed, thr, valid):
        elem, shape = _plane_elem(store, name, words)
        return counter_flip_words(words, seed, thr, valid, model=model,
                                  elem=elem, shape=shape)

    man = flip("man", store.man, seeds["man"], thr_man,
               (1 << cfg.fmt.man_bits) - 1)
    sign, exp, cw = store.sign, store.exp, store.codewords
    if cw is not None:
        cw = flip("cw", cw, seeds["cw"], thr_meta, codeword_valid_masks(cfg))
    else:
        exp = flip("exp", exp, seeds["meta"], thr_meta,
                   (1 << cfg.fmt.exp_bits) - 1)
        sh = store.shard
        if sh is not None and sh.sharded and sh.dim == "k":
            # a K shard holds whole 32-row words (can_shard_store), so
            # every lane is a stored cell: the reference's scalar mask
            valid = M32
        else:
            valid = bitpack.word_masks(store.man.shape[0],
                                       sign.shape[0])[:, None]
        sign = flip("sign", sign, seeds["cw"], thr_meta, valid)
    return CIMStore(man=man, sign=sign, exp=exp, codewords=cw,
                    shape=store.shape, cfg=cfg, shard=store.shard)


def field_thresholds(ber, field: str = "full") -> Tuple[int, int]:
    """(thr_man, thr_meta) of a BER restricted to ``field``."""
    thr = ber_to_threshold(ber)
    return (thr if field in ("full", "mantissa") else 0,
            thr if field in ("full", "exponent_sign") else 0)


def inject(seeds: dict, store: CIMStore, ber, field: str = "full",
           model=None) -> CIMStore:
    """Flip stored bits at rate ``ber`` in ``field`` from per-plane seeds
    (the reference's ``inject(key, ...)`` with ``plane_seeds(key)``)."""
    if ber <= 0.0:
        return store
    thr_man, thr_meta = field_thresholds(ber, field)
    return inject_with_seeds(store, seeds, thr_man, thr_meta, model=model)


def inject_sharded(seeds: dict, store: CIMStore, ber, field: str = "full",
                   model=None) -> CIMStore:
    """:func:`inject` of one shard of a mesh-sharded image (the reference's
    ``inject_sharded``): every local word draws at its GLOBAL C-order index
    and the fault process compiles against the global plane shapes, so the
    shard equals the block of the single-device ``inject`` at the same
    seeds, bit for bit."""
    if store.shard is None:
        raise ValueError("inject_sharded: the store is not a shard "
                         "(shard_store)")
    return inject(seeds, store, ber, field, model=model)


# ---------------------------------------------------------------------------
# Read path: packed ECC decode + FP reconstruction.
# ---------------------------------------------------------------------------


def _stats(status) -> dict:
    if status is None:
        return {"corrected": 0, "uncorrectable": 0}
    return {"corrected": int((status == 1).sum()),
            "uncorrectable": int((status == 2).sum())}


def _decode_planes(store: CIMStore):
    """-> (e_block [B, J_pad] or None, (e_full or None, sign [K_pad, J_pad]),
    status or None)."""
    cfg = store.cfg
    n, rw = cfg.n_group, cfg.row_weights
    k_pad, j_pad = store.man.shape
    b = k_pad // n
    if store.codewords is not None and cfg.protect == "per_weight":
        data, status = cfg.pw_code.decode_packed(store.codewords[..., None])
        data = data[..., 0]
        eb = cfg.fmt.exp_bits
        return None, (data & ((1 << eb) - 1), (data >> eb) & 1), status
    if store.codewords is not None:
        exp_rows, sign_words, status = cfg.codec.decode_packed(store.codewords)
        e_block = exp_rows.reshape(b, j_pad)
        sw_list = [sign_words[..., v] for v in range(sign_words.shape[-1])]
        shifts = torch.arange(rw, dtype=torch.int64, device=store.device)
        rows = []
        for i_n in range(n):
            sv = bitpack.extract_window(sw_list, i_n * rw, rw)[0]     # [B, G]
            rows.append(((sv[..., None] >> shifts) & 1).reshape(b, j_pad))
        sign = torch.stack(rows, dim=1).reshape(k_pad, j_pad)
        return e_block, (None, sign), status
    return store.exp, (None, unpack_sign_plane(store.sign, k_pad)), None


def read(store: CIMStore):
    """Packed ECC decode (if protected) + FP reconstruction ->
    (weights float32 [K, J], {'corrected', 'uncorrectable'} as ints)."""
    e_block, (e_full, sign), status = _decode_planes(store)
    if e_block is not None:
        e_full = torch.repeat_interleave(e_block.to(torch.int64),
                                         store.cfg.n_group, dim=0)
    w = bitops.fields_to_f32(sign, e_full, store.man, store.cfg.fmt)
    k, j = store.shape
    return w[:k, :j], _stats(status)


def build_row_cache(store: CIMStore) -> CIMStore:
    """Attach the decoded-row cache ``store.cache = read(store)[0]``."""
    return dataclasses.replace(store, cache=read(store)[0].contiguous())


def drop_row_cache(store: CIMStore) -> CIMStore:
    """``store`` without its decoded-row cache (itself when it has none)."""
    if store.cache is None:
        return store
    return dataclasses.replace(store, cache=None)


def read_reference(store: CIMStore):
    """Per-bit oracle for :func:`read`: unpack the packed planes to one byte
    a bit and decode with the per-bit SECDED codecs
    (:meth:`~repro_torch.core.ecc.SecdedCode.decode`). Kept as the
    equivalence baseline of the packed path; never on a hot path."""
    cfg = store.cfg
    n = cfg.n_group
    k_pad, j_pad = store.man.shape
    b = k_pad // n
    if store.codewords is not None and cfg.protect == "per_weight":
        code = cfg.pw_code
        cw_bits = bitpack.unpack_words(store.codewords[..., None], code.n)
        data, status = code.decode(cw_bits)
        eb = cfg.fmt.exp_bits
        shifts = torch.arange(eb, dtype=torch.int64, device=store.device)
        e_full = (data[..., :eb].to(torch.int64) << shifts).sum(-1)
        sign = data[..., eb]
    elif store.codewords is not None:
        codec = cfg.codec
        cw_bits = bitpack.unpack_words(store.codewords, codec.code.n)
        exp_rows, signs, status = codec.decode(cw_bits)
        e_full = torch.repeat_interleave(exp_rows.reshape(b, j_pad), n, dim=0)
        sign = signs.permute(0, 2, 1, 3).reshape(k_pad, j_pad)
    else:
        e_full = torch.repeat_interleave(store.exp.to(torch.int64), n, dim=0)
        sign = unpack_sign_plane(store.sign, k_pad)
        status = None
    w = bitops.fields_to_f32(sign, e_full, store.man, cfg.fmt)
    k, j = store.shape
    return w[:k, :j], _stats(status)


def can_shard_store(store: CIMStore, n_shards: int, dim: str = "j") -> bool:
    """Whether every plane splits evenly into ``n_shards`` along ``dim``:
    ``'j'`` in whole ``row_weights`` column groups, ``'k'`` in whole
    exponent blocks (and whole 32-row sign words for ``protect='none'``)."""
    if n_shards == 1:
        return True
    k_pad, j_pad = store.man.shape
    cfg = store.cfg
    if dim == "j":
        return j_pad % (n_shards * cfg.row_weights) == 0
    if dim == "k":
        if k_pad % (n_shards * cfg.n_group) != 0:
            return False
        return store.sign is None or k_pad % (n_shards * 32) == 0
    raise ValueError(f"dim must be 'j' or 'k', got {dim!r}")


def shard_store(store: CIMStore, n_shards: int, index: int,
                dim: str = "j", split: bool = True) -> CIMStore:
    """Block ``index`` of ``n_shards`` of the image along ``dim``: every
    plane's dimension 1 (columns, column groups) for ``'j'``, dimension 0
    (K rows, exponent blocks, sign words) for ``'k'``, as contiguous
    copies, with a :class:`ShardInfo` of the global image. Its ``shape`` is
    (K, J_pad / n) or (K_pad / n, J). An image that does not split evenly,
    or any image with ``split=False`` (a store the sharded read route does
    not take), stays whole (``ShardInfo.sharded`` False), as the
    reference's placement leaves it replicated. A decoded-row cache is
    rebuilt for a block."""
    if store.shard is not None:
        raise ValueError("shard_store: the store is already a shard")
    if not 0 <= index < n_shards:
        raise ValueError(f"shard_store: index {index} of {n_shards}")
    ok = split and can_shard_store(store, n_shards, dim)
    planes = plane_dict(store)
    info = ShardInfo(n_shards=n_shards, index=index, dim=dim, sharded=ok,
                     global_shape=tuple(store.shape),
                     global_pad=tuple(store.man.shape),
                     plane_shapes=tuple((k, tuple(v.shape))
                                        for k, v in planes.items()))
    if not ok:
        return dataclasses.replace(store, shard=info)
    sdim = info.sdim

    def cut(p):
        size = p.shape[sdim] // n_shards
        return p.narrow(sdim, index * size, size).contiguous()
    planes = {k: cut(v) for k, v in planes.items()}
    k_log, j_log = store.shape
    shape = (k_log, planes["man"].shape[1]) if dim == "j" \
        else (planes["man"].shape[0], j_log)
    out = CIMStore(man=planes["man"], sign=planes.get("sign"),
                   exp=planes.get("exp"), codewords=planes.get("cw"),
                   shape=shape, cfg=store.cfg, shard=info)
    return build_row_cache(out) if store.cache is not None else out


def plane_dict(store: CIMStore) -> dict:
    """The store's populated planes by name (``man``, ``sign``, ``exp``,
    ``cw``), as the reference's ``_plane_dict``."""
    planes = {"man": store.man, "sign": store.sign, "exp": store.exp,
              "cw": store.codewords}
    return {k: v for k, v in planes.items() if v is not None}


def store_stats(store: CIMStore) -> dict:
    """ECC status counts without reconstructing weights."""
    if store.codewords is None:
        return _stats(None)
    if store.cfg.protect == "per_weight":
        _, status = store.cfg.pw_code.decode_packed(store.codewords[..., None])
    else:
        _, _, status = store.cfg.codec.decode_packed(store.codewords)
    return _stats(status)


def read_rows(store: CIMStore, idx: torch.Tensor, seeds=None, thr_man=0,
              thr_meta=0, model=None) -> torch.Tensor:
    """Decode-on-read row gather: fp32 rows ``[*idx.shape, J]`` decoding only
    the gathered rows' cells. With ``seeds``, fresh faults hit the gathered
    cells first, bit-identical to :func:`inject_with_seeds` on the whole
    store restricted to those cells."""
    cfg = store.cfg
    n, rw = cfg.n_group, cfg.row_weights
    k_pad, j_pad = store.man.shape
    g = j_pad // rw
    dev = store.device
    dyn = seeds is not None
    idx = idx.to(torch.int64)
    # a column shard draws at global coordinates: its columns start at
    # off_j of a J_pad-wide image (its codeword groups at off_j / rw)
    sh = store.shard
    off_j, gj_pad = 0, j_pad
    if sh is not None and sh.sharded:
        if sh.dim != "j":
            raise NotImplementedError(
                "read_rows of a K-sharded store: rows are whole on a column "
                "shard only (serving places dim='j')")
        off_j, gj_pad = sh.offsets[1], sh.global_pad[1]
    cols = torch.arange(j_pad, dtype=torch.int64, device=dev) + off_j

    def gshape(name, plane):
        return sh.plane_shape(name) if gj_pad != j_pad else plane.shape

    def mthr(thr, elem_, seed_, shape_):
        return fm.plane_thresholds(model, thr, elem_, seed_, shape_)

    man = _rows(store.man, idx)                                  # [..., J_pad]
    if dyn:
        elem = idx[..., None] * gj_pad + cols
        man = _flip_gathered(man, elem, seeds["man"],
                             mthr(thr_man, elem, seeds["man"],
                                  gshape("man", store.man)),
                             (1 << cfg.fmt.man_bits) - 1)

    if store.codewords is not None and cfg.protect == "per_weight":
        cw = _rows(store.codewords, idx)
        if dyn:
            cw = _flip_gathered(cw, elem, seeds["cw"],
                                mthr(thr_meta, elem, seeds["cw"],
                                     gshape("cw", store.codewords)),
                                int(codeword_valid_masks(cfg)))
        data, _ = cfg.pw_code.decode_packed(cw[..., None])
        data = data[..., 0]
        eb = cfg.fmt.exp_bits
        e_rows, s_rows = data & ((1 << eb) - 1), (data >> eb) & 1
    elif store.codewords is not None:
        codec = cfg.codec
        blk = idx // n
        i_n = idx % n
        cw = store.codewords[blk]                                # [..., G, S, W]
        if dyn:
            s_, w_ = codec.n_segments, codec.codeword_words
            inner = torch.arange(g * s_ * w_, dtype=torch.int64,
                                 device=dev).reshape(g, s_, w_) \
                + off_j // rw * s_ * w_
            celem = blk[..., None, None, None] * (gj_pad // rw * s_ * w_) \
                + inner
            cw = _flip_gathered(cw, celem, seeds["cw"],
                                mthr(thr_meta, celem, seeds["cw"],
                                     gshape("cw", store.codewords)),
                                codeword_valid_masks(cfg)[None, None, :])
        exp_rows, sign_words, _ = codec.decode_packed(cw)
        e_rows = exp_rows.reshape(exp_rows.shape[:-2] + (j_pad,))
        signs = codec.unpack_signs(sign_words)                   # [..., G, N, rw]
        sel = i_n[..., None, None, None].expand(
            signs.shape[:-2] + (1, rw))
        s_rows = torch.gather(signs, -2, sel)[..., 0, :]
        s_rows = s_rows.reshape(s_rows.shape[:-2] + (j_pad,))
    else:
        blk = idx // n
        e_rows = store.exp[blk]
        sw = store.sign[idx // 32]
        if dyn:
            eelem = blk[..., None] * gj_pad + cols
            e_rows = _flip_gathered(e_rows, eelem, seeds["meta"],
                                    mthr(thr_meta, eelem, seeds["meta"],
                                         gshape("exp", store.exp)),
                                    (1 << cfg.fmt.exp_bits) - 1)
            selem = (idx // 32)[..., None] * gj_pad + cols
            svalid = M32 if k_pad % 32 == 0 else (1 << (k_pad % 32)) - 1
            # rows in a full word see all 32 lanes; the last partial word
            # only its valid lanes (the masks `inject_with_seeds` uses)
            full = (idx // 32 + 1) * 32 <= k_pad
            vmask = torch.where(full[..., None], M32, svalid).expand(sw.shape)
            sw = _flip_gathered(sw, selem, seeds["cw"],
                                mthr(thr_meta, selem, seeds["cw"],
                                     gshape("sign", store.sign)), vmask)
        s_rows = (bitpack.widen(sw) >> (idx % 32)[..., None]) & 1
    w = bitops.fields_to_f32(s_rows, e_rows, man, cfg.fmt)
    return w[..., :store.shape[1]]


# ---------------------------------------------------------------------------
# Model level: deploy a whole parameter tree (core/tree.py order) onto
# emulated CIM macros. The sweep engine's Fig. 6 arms run on these.
# ---------------------------------------------------------------------------


def _deployable(path: str, leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.ndim == 2 \
        and leaf.is_floating_point()


def _is_store(x) -> bool:
    return isinstance(x, CIMStore)


def deploy_pytree_impl(params: Mapping, cfg: CIMConfig, align_cfg=None,
                       predicate=_deployable):
    """Align + pack every 2-D weight; other leaves pass through (the same
    tensors). Returns (stores, aligned), both ``{path: leaf}`` in flatten
    order. Leaves above 2-D (layer-stacked blocks, conv kernels) stay
    plain, as in the reference."""
    if align_cfg is None:
        align_cfg = align_lib.AlignmentConfig(n_group=cfg.n_group,
                                              index=cfg.index, fmt=cfg.fmt)
    stores, aligned = {}, {}
    for path, leaf in tree.flatten(params).items():
        if predicate(path, leaf):
            w_al, _ = align_lib.align_matrix(leaf, align_cfg)
            stores[path] = pack(w_al, cfg)
            aligned[path] = w_al
        else:
            stores[path] = aligned[path] = leaf
    return stores, aligned


def read_pytree_impl(stores: Mapping):
    """Decode every store -> (params, {'corrected', 'uncorrectable'} summed
    over the stores)."""
    out, corrected, uncorrectable = {}, 0, 0
    for path, leaf in tree.flatten(stores).items():
        if _is_store(leaf):
            w, st = read(leaf)
            out[path] = w
            corrected += st["corrected"]
            uncorrectable += st["uncorrectable"]
        else:
            out[path] = leaf
    return out, {"corrected": corrected, "uncorrectable": uncorrectable}
