"""SECDED and One4N row codes, word-packed path (port of ``repro/core/ecc.py``).

The packed (uint32-word) API is the one every path runs. Of the reference's
per-bit oracle codecs only the decoders are ported (``SecdedCode.decode``,
``One4NRowCodec.decode``): :func:`repro_torch.core.cim.read_reference`
decodes with them, as the reference's oracle does. The generator/parity-check
tables are numpy, copied from the reference.

Decode syndrome semantics (paper Fig. 4 ③): ``R == 0`` clean; overall parity
set -> single error at ``R[6:0]``, corrected; parity clear with ``R != 0`` ->
uncorrectable. Status codes 0/1/2.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitpack

# Max data bits covered by one SECDED row with a 7-bit Hamming syndrome.
MAX_SEGMENT_DATA_BITS = 104


def _hamming_r(d: int) -> int:
    r = 1
    while (1 << r) < d + r + 1:
        r += 1
    return r


@functools.lru_cache(maxsize=None)
def _secded_tables(d: int):
    """Position layout + parity-check matrix for d data bits."""
    r = _hamming_r(d)
    n = d + r
    positions = np.arange(1, n + 1)
    is_parity = (positions & (positions - 1)) == 0
    data_pos = positions[~is_parity]
    parity_pos = positions[is_parity]
    H = ((positions[None, :] >> np.arange(r)[:, None]) & 1).astype(np.int32)
    enc = H[:, ~is_parity]
    return r, n, data_pos - 1, parity_pos - 1, H, enc


@functools.lru_cache(maxsize=None)
def _secded_packed_tables(d: int):
    """Per-word column masks for the packed encode/decode of ``d`` data bits.

    Body bit ``i`` (position ``i+1``) at word ``i//32`` lane ``i%32``; the
    overall parity bit at bit index ``n``."""
    r, n, data_idx, _, _, _ = _secded_tables(d)
    Wd = bitpack.n_words(d)
    Wc = bitpack.n_words(n + 1)
    hmask = np.zeros((r, Wc), np.uint32)
    for i in range(n):
        for j in range(r):
            if ((i + 1) >> j) & 1:
                hmask[j, i // 32] |= np.uint32(1 << (i % 32))
    encmask = np.zeros((r, Wd), np.uint32)
    for q, i in enumerate(data_idx):
        for j in range(r):
            if ((i + 1) >> j) & 1:
                encmask[j, q // 32] |= np.uint32(1 << (q % 32))
    body_mask = bitpack.word_masks(n, Wc)
    code_mask = bitpack.word_masks(n + 1, Wc)
    data_mask = bitpack.word_masks(d, Wd)
    parity_pos0 = tuple((1 << j) - 1 for j in range(r))
    return r, n, Wd, Wc, hmask, encmask, body_mask, code_mask, data_mask, \
        parity_pos0


@dataclasses.dataclass(frozen=True)
class SecdedCode:
    """Extended Hamming SECDED over ``data_bits`` bits (packed words)."""

    data_bits: int

    @property
    def r(self) -> int:
        return _secded_tables(self.data_bits)[0]

    @property
    def n_body(self) -> int:
        """Codeword length without the overall parity bit."""
        return _secded_tables(self.data_bits)[1]

    @property
    def n(self) -> int:
        """Codeword length including the overall parity bit."""
        return self.n_body + 1

    @property
    def redundant_bits(self) -> int:
        return self.r + 1

    @property
    def data_words(self) -> int:
        return bitpack.n_words(self.data_bits)

    @property
    def code_words(self) -> int:
        return bitpack.n_words(self.n)

    @property
    def code_word_masks(self) -> np.ndarray:
        """uint32 [code_words] validity mask of stored codeword bits."""
        return _secded_packed_tables(self.data_bits)[7]

    @property
    def syndrome_masks(self) -> np.ndarray:
        """uint32 [r, code_words]: bit ``l`` of word ``w`` is in syndrome bit
        ``j`` iff bit ``j`` of its 1-based position ``32 w + l + 1`` is set."""
        return _secded_packed_tables(self.data_bits)[4]

    def decode(self, code: torch.Tensor):
        """Per-bit oracle: codeword bits [..., n] -> (data bits [..., d]
        uint8, status [...] int64: 0 clean, 1 corrected, 2 uncorrectable)."""
        r, n, data_idx, _, H, _ = _secded_tables(self.data_bits)
        dev = code.device
        body = code[..., :n].to(torch.int64)
        overall = code[..., n].to(torch.int64)
        syn = (body @ torch.as_tensor(H.T, dtype=torch.int64,
                                      device=dev)) & 1
        pos = (syn << torch.arange(r, device=dev)).sum(-1)
        parity = (body.sum(-1) + overall) & 1
        clean = (pos == 0) & (parity == 0)
        single = parity == 1
        double = (parity == 0) & (pos > 0)
        flip = (torch.arange(1, n + 1, device=dev) == pos[..., None]) \
            & single[..., None]
        corrected = body ^ flip.to(torch.int64)
        data = corrected[..., torch.as_tensor(data_idx, device=dev)]
        status = torch.where(clean, 0, torch.where(double, 2, 1))
        return data.to(torch.uint8), status

    def encode_packed(self, data_words: torch.Tensor) -> torch.Tensor:
        """data [..., data_words] -> codewords [..., code_words] (int64)."""
        r, n, Wd, Wc, _, encmask, _, _, data_mask, parity_pos0 = \
            _secded_packed_tables(self.data_bits)
        dw = [bitpack.widen(data_words[..., w]) & int(data_mask[w])
              for w in range(Wd)]
        parity = [bitpack.masked_parity(dw, encmask[j]) for j in range(r)]
        body = dw + [torch.zeros_like(dw[0]) for _ in range(Wc - Wd)]
        for pp in parity_pos0:
            body = bitpack.insert_zero_bit(body, pp)
        for j, pp in enumerate(parity_pos0):
            wl, sh = divmod(pp, 32)
            body[wl] = body[wl] | (parity[j] << sh)
        overall = bitpack.masked_parity(body, bitpack.word_masks(n, Wc))
        wl, sh = divmod(n, 32)
        body[wl] = body[wl] | (overall << sh)
        return bitpack.from_words(body)

    def syndrome_packed(self, code_words: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (1-based error position R[6:0], overall parity R[7], status)."""
        r, n, Wd, Wc, hmask, _, body_mask, _, _, _ = \
            _secded_packed_tables(self.data_bits)
        cw = [bitpack.widen(code_words[..., w]) for w in range(Wc)]
        body = [cw[w] & int(body_mask[w]) for w in range(Wc)]
        synd = [bitpack.masked_parity(body, hmask[j]) for j in range(r)]
        pos = synd[0]
        for j in range(1, r):
            pos = pos | (synd[j] << j)
        owl, osh = divmod(n, 32)
        overall_bit = (cw[owl] >> osh) & 1
        parity = bitpack.masked_parity(body, bitpack.word_masks(n, Wc)) \
            ^ overall_bit
        clean = (pos == 0) & (parity == 0)
        double = (parity == 0) & (pos > 0)
        status = torch.where(clean, 0, torch.where(double, 2, 1))
        return pos, parity, status

    def correct_extract_packed(self, code_words: torch.Tensor, pos, parity
                               ) -> torch.Tensor:
        """Flip the located single error, drop the parity positions ->
        data words [..., data_words] (int64)."""
        r, n, Wd, Wc, _, _, body_mask, _, data_mask, parity_pos0 = \
            _secded_packed_tables(self.data_bits)
        cw = [bitpack.widen(code_words[..., w]) for w in range(Wc)]
        body = [cw[w] & int(body_mask[w]) for w in range(Wc)]
        do_flip = (parity == 1) & (pos > 0)
        pos0 = torch.where(pos > 0, pos - 1, torch.zeros_like(pos))
        flip_word = pos0 // 32
        flip_bit = torch.ones_like(pos0) << (pos0 % 32)
        for w in range(Wc):
            flipw = torch.where(do_flip & (flip_word == w), flip_bit,
                                torch.zeros_like(flip_bit)) & int(body_mask[w])
            body[w] = body[w] ^ flipw
        for pp in reversed(parity_pos0):
            body = bitpack.delete_bit(body, pp)
        return bitpack.from_words([body[w] & int(data_mask[w])
                                   for w in range(Wd)])

    def decode_packed(self, code_words: torch.Tensor):
        """codewords [..., code_words] -> (data words, status 0/1/2)."""
        pos, parity, status = self.syndrome_packed(code_words)
        return self.correct_extract_packed(code_words, pos, parity), status


@dataclasses.dataclass(frozen=True)
class One4NRowCodec:
    """Row-based One4N payload codec for an ``N x row_weights`` weight block:
    ``[exp_0 .. exp_{rw-1}] || sign bits (N x rw)`` split into SECDED rows."""

    n_group: int = 8
    row_weights: int = 16
    exp_bits: int = 5
    sign_bits_per_row: int = 16

    @property
    def payload_bits(self) -> int:
        return self.exp_bits * self.row_weights \
            + self.n_group * self.sign_bits_per_row

    @property
    def n_segments(self) -> int:
        return math.ceil(self.payload_bits / MAX_SEGMENT_DATA_BITS)

    @property
    def segment_bits(self) -> int:
        return math.ceil(self.payload_bits / self.n_segments)

    @property
    def code(self) -> SecdedCode:
        return SecdedCode(self.segment_bits)

    @property
    def padded_bits(self) -> int:
        return self.n_segments * self.segment_bits

    @property
    def sign_bits(self) -> int:
        return self.n_group * self.sign_bits_per_row

    @property
    def sign_words(self) -> int:
        return bitpack.n_words(self.sign_bits)

    @property
    def payload_words(self) -> int:
        return bitpack.n_words(self.padded_bits)

    @property
    def codeword_words(self) -> int:
        return self.code.code_words

    def pack_signs(self, signs: torch.Tensor) -> torch.Tensor:
        """signs [..., N, row_weights] bits -> packed [..., sign_words]."""
        flat = signs.reshape(signs.shape[:-2] + (self.sign_bits,))
        return bitpack.pack_bits_words(flat, self.sign_bits)

    def unpack_signs(self, sign_words: torch.Tensor) -> torch.Tensor:
        """Packed [..., sign_words] -> signs [..., N, row_weights] uint8."""
        bits = bitpack.unpack_words(sign_words, self.sign_bits)
        return bits.reshape(bits.shape[:-1]
                            + (self.n_group, self.sign_bits_per_row))

    def decode(self, codewords: torch.Tensor):
        """Per-bit oracle: codeword bits [..., n_segments, code.n] ->
        (exp_row [..., rw] int64, signs [..., N, rw] uint8, status [...,
        n_segments])."""
        data, status = self.code.decode(codewords)
        payload = data.reshape(data.shape[:-2] + (self.padded_bits,))
        eb, rw = self.exp_bits, self.row_weights
        exp_bits = payload[..., :eb * rw].reshape(payload.shape[:-1]
                                                  + (rw, eb))
        shifts = torch.arange(eb, dtype=torch.int64, device=payload.device)
        exp_row = (exp_bits.to(torch.int64) << shifts).sum(-1)
        sb = self.n_group * self.sign_bits_per_row
        signs = payload[..., eb * rw:eb * rw + sb].reshape(
            payload.shape[:-1] + (self.n_group, self.sign_bits_per_row))
        return exp_row, signs, status

    def build_payload_packed(self, exp_row: torch.Tensor,
                             sign_words: torch.Tensor):
        """exp_row [..., rw] + packed signs -> payload word list."""
        eb, rw = self.exp_bits, self.row_weights
        pw = bitpack.zeros_like_words(exp_row[..., 0], self.payload_words)
        for t in range(rw):
            bitpack.or_window(pw, [bitpack.widen(exp_row[..., t])], t * eb, eb)
        off = rw * eb
        for v in range(self.sign_words):
            nb = min(32, self.sign_bits - 32 * v)
            bitpack.or_window(pw, [bitpack.widen(sign_words[..., v])],
                              off + 32 * v, nb)
        return pw

    def split_payload_packed(self, pw):
        """Payload word list -> (exp_row [..., rw] uint8, sign_words)."""
        eb, rw = self.exp_bits, self.row_weights
        exps = [bitpack.extract_window(pw, t * eb, eb)[0] for t in range(rw)]
        exp_row = torch.stack(exps, dim=-1).to(torch.uint8)
        off = rw * eb
        svs = [bitpack.extract_window(pw, off + 32 * v,
                                      min(32, self.sign_bits - 32 * v))[0]
               for v in range(self.sign_words)]
        return exp_row, torch.stack(svs, dim=-1)

    def encode_packed(self, exp_row: torch.Tensor,
                      sign_words: torch.Tensor) -> torch.Tensor:
        """-> codewords [..., n_segments, codeword_words] (int64)."""
        pw = self.build_payload_packed(exp_row, sign_words)
        segs = [bitpack.from_words(
            bitpack.extract_window(pw, s * self.segment_bits, self.segment_bits))
            for s in range(self.n_segments)]
        return self.code.encode_packed(torch.stack(segs, dim=-2))

    def decode_packed(self, codewords: torch.Tensor):
        """Codewords [..., n_segments, codeword_words] -> (exp_row [..., rw],
        sign_words [..., sign_words], status [..., n_segments])."""
        data, status = self.code.decode_packed(codewords)
        pw = bitpack.zeros_like_words(data[..., 0, 0], self.payload_words)
        for s in range(self.n_segments):
            bitpack.or_window(pw, [data[..., s, w] for w in range(data.shape[-1])],
                              s * self.segment_bits, self.segment_bits)
        return (*self.split_payload_packed(pw), status)


def residual_ber_after_secded(ber: float, codeword_bits: Optional[int] = None,
                              codec: Optional[One4NRowCodec] = None) -> float:
    """Post-ECC residual error rate per protected bit, in closed form.

    SECDED corrects one flip per codeword; a bit stays wrong only when its
    codeword took >= 2 flips. With n-bit codewords and i.i.d. flips at
    ``ber``: ``P(>=2) = 1 - (1-p)^n - n p (1-p)^(n-1)``, and given that,
    about 2 of the n bits are wrong. ``codeword_bits`` defaults to the
    stored codeword length of ``codec`` (or of the default
    :class:`One4NRowCodec`, 112 bits for N = 8). The training fault
    schedule draws the exponent/sign field at this rate."""
    if codeword_bits is None:
        codeword_bits = (codec or One4NRowCodec()).code.n
    n, p = codeword_bits, ber
    if p <= 0:
        return 0.0
    p_ge2 = 1.0 - (1.0 - p) ** n - n * p * (1.0 - p) ** (n - 1)
    return p_ge2 * 2.0 / n
