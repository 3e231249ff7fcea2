"""Multiword bit-plane arithmetic (port of ``repro/core/bitpack.py``).

A multiword bit string lives across the last axis of a word array: bit ``i``
in word ``i // 32`` at lane ``i % 32`` (LSB first). Inside the algorithms a
value is a Python list of per-word ``int64`` tensors holding uint32 values in
``[0, 2^32)``: every left shift is masked back to 32 bits, so every right
shift stays logical. Storage planes keep uint32 words as ``torch.int32``
views (:func:`widen` / :func:`narrow_u32` convert).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

WORD = 32
M32 = 0xFFFFFFFF
_FULL = np.uint32(0xFFFFFFFF)


def n_words(nbits: int) -> int:
    """Number of uint32 words needed to hold ``nbits`` bits."""
    return (nbits + WORD - 1) // WORD


def word_masks(nbits: int, W: int | None = None) -> np.ndarray:
    """uint32 [W] validity mask: bit set iff that bit index is < ``nbits``."""
    W = n_words(nbits) if W is None else W
    out = np.zeros((W,), np.uint32)
    for w in range(W):
        valid = min(max(nbits - w * WORD, 0), WORD)
        out[w] = _FULL if valid == WORD else np.uint32((1 << valid) - 1)
    return out


def widen(t: torch.Tensor) -> torch.Tensor:
    """Any integer plane -> int64 holding the unsigned value (an int32 view
    of a uint32 word comes back in ``[0, 2^32)``)."""
    return t.to(torch.int64) & M32


def narrow_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> the ``int32`` view of the uint32
    words (two's-complement wrap)."""
    return t.to(torch.int32)


def from_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """List of per-word tensors -> stacked [..., W] int64 array."""
    return torch.stack([w.to(torch.int64) for w in words], dim=-1)


def zeros_like_words(ref: torch.Tensor, W: int) -> List[torch.Tensor]:
    z = torch.zeros(ref.shape, dtype=torch.int64, device=ref.device)
    return [z for _ in range(W)]


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Bit parity of each uint32 element (0 or 1), via xor-folding."""
    x = x & M32
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def masked_parity(words: Sequence[torch.Tensor], masks: np.ndarray) -> torch.Tensor:
    """Parity of the bits selected by per-word ``masks`` (uint32 [W])."""
    acc = words[0] & int(masks[0])
    for w in range(1, len(words)):
        if int(masks[w]) == 0:
            continue
        acc = acc ^ (words[w] & int(masks[w]))
    return parity32(acc)


def _shl(v: torch.Tensor, sh: int) -> torch.Tensor:
    return (v << sh) & M32


def extract_window(words: Sequence[torch.Tensor], start: int,
                   nbits: int) -> List[torch.Tensor]:
    """Bits [start, start+nbits) as a fresh ``n_words(nbits)``-word value."""
    W = len(words)
    masks = word_masks(nbits)
    out = []
    for ow in range(n_words(nbits)):
        wl, sh = divmod(start + ow * WORD, WORD)
        v = (words[wl] >> sh) if wl < W else torch.zeros_like(words[0])
        if sh and wl + 1 < W:
            v = v | _shl(words[wl + 1], WORD - sh)
        out.append(v & int(masks[ow]))
    return out


def or_window(dst: List[torch.Tensor], src: Sequence[torch.Tensor], start: int,
              nbits: int) -> None:
    """OR an ``nbits``-wide value into ``dst`` at bit offset ``start``
    (mutates the ``dst`` list in place; ``dst`` is zero in the window)."""
    masks = word_masks(nbits)
    for sw in range(n_words(nbits)):
        if sw >= len(src):
            break
        s = src[sw] & int(masks[sw])
        wl, sh = divmod(start + sw * WORD, WORD)
        if wl < len(dst):
            dst[wl] = dst[wl] | (_shl(s, sh) if sh else s)
        if sh and wl + 1 < len(dst):
            dst[wl + 1] = dst[wl + 1] | (s >> (WORD - sh))


def insert_zero_bit(words: Sequence[torch.Tensor], pos: int) -> List[torch.Tensor]:
    """Insert a zero bit at ``pos``, shifting higher bits up by one (the top
    bit of the last word is shifted out)."""
    W = len(words)
    shifted = []
    for w in range(W):
        v = _shl(words[w], 1)
        if w > 0:
            v = v | (words[w - 1] >> (WORD - 1))
        shifted.append(v)
    wl, sh = divmod(pos, WORD)
    lo = (1 << sh) - 1
    hi = ((1 << (sh + 1)) - 1) & M32
    out = []
    for w in range(W):
        if w < wl:
            out.append(words[w])
        elif w == wl:
            out.append((words[w] & lo) | (shifted[w] & (M32 ^ hi)))
        else:
            out.append(shifted[w])
    return out


def delete_bit(words: Sequence[torch.Tensor], pos: int) -> List[torch.Tensor]:
    """Remove the bit at ``pos``, shifting higher bits down by one."""
    W = len(words)
    shifted = []
    for w in range(W):
        v = words[w] >> 1
        if w + 1 < W:
            v = v | _shl(words[w + 1], WORD - 1)
        shifted.append(v)
    wl, sh = divmod(pos, WORD)
    lo = (1 << sh) - 1
    out = []
    for w in range(W):
        if w < wl:
            out.append(words[w])
        elif w == wl:
            out.append((words[w] & lo) | (shifted[w] & (M32 ^ lo)))
        else:
            out.append(shifted[w])
    return out


def pack_bits_words(bits: torch.Tensor, nbits: int | None = None) -> torch.Tensor:
    """Bit array [..., nbits] (LSB first, {0,1}) -> packed [..., W] int64."""
    nbits = bits.shape[-1] if nbits is None else nbits
    W = n_words(nbits)
    b = bits.to(torch.int64)
    pad = W * WORD - nbits
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (W, WORD))
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    return (b << shifts).sum(-1)


def unpack_words(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Packed [..., W] words -> bit array [..., nbits] uint8 (LSB first)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = ((widen(words)[..., None] >> shifts) & 1).to(torch.uint8)
    bits = bits.reshape(bits.shape[:-2] + (words.shape[-1] * WORD,))
    return bits[..., :nbits]
