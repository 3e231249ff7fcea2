"""Model configs (port of ``repro/configs/base.py``).

Declared again here because the reference's module imports ``jax.numpy``.
Only the fields the attention-family LM reads are carried over; the
architectures beyond olmo-1b wait (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    block_pattern: Tuple[str, ...] = ("attn",)
    modality: str = "text"
    rope_theta: float = 1e4
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    attn_chunk_q: int = 1024
    attn_chunk_threshold: int = 8192
    tag: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests (the reference's
        ``reduced()`` on the fields carried here)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if len(self.block_pattern) < 2
                         else len(self.block_pattern)),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, max(1, min(self.n_heads, 4) // 2))
            if self.n_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256,
            vocab_size=256,
            attn_chunk_threshold=10 ** 9,
        )


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    from repro_torch import configs as _  # noqa: F401  (registers the archs)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()

