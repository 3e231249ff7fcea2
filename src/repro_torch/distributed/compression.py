"""Int8 error-feedback gradient compression (port of
``repro/distributed/compression.py``).

Per-tensor symmetric int8 quantization with an error-feedback accumulator
(EF-SGD): the quantization residual is added back into the next step's
gradient, which keeps convergence. On a fleet the int8 payload is what
crosses the cross-pod all-reduce (4x fewer bytes than fp32); here the
quantize -> dequantize pair runs in the step, so the numerics are those of
the deployed path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes, float32 scale): scale = max(max|x|, 1e-12) / 127,
    codes = clip(round_half_even(x / scale), -127, 127)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads: Dict[str, Optional[torch.Tensor]],
                        ef_error: Dict[str, Optional[torch.Tensor]]):
    """grads + EF residual -> int8 round trip -> (decompressed grads, new
    EF residual), leaf by leaf (``None`` leaves pass through)."""
    new_g, new_e = {}, {}
    for path, g in grads.items():
        if g is None:
            new_g[path], new_e[path] = None, ef_error.get(path)
            continue
        x = g.to(torch.float32) + ef_error[path]
        deq = dequantize_int8(*quantize_int8(x))
        new_g[path] = deq.to(g.dtype)
        new_e[path] = x - deq
    return new_g, new_e
