"""Model configs (port of ``repro/configs/base.py``).

Declared again here because the reference's module imports ``jax.numpy``.
The fields of every block kind are carried over (``attn``, ``local``,
``moe``, ``rwkv``, ``rec``), and ``kv_cache_dtype`` (``"int8"``: the
engine's K/V rows as int8 values with a bf16 scale a token and head); left
out are the reference's sharding choices (``attn_impl``, ``mlp_impl``).
``moe_dispatch="a2a"`` means the dense dispatch on
one device, as the reference falls back to it without a mesh.
``RunConfig`` describes one training run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
    mlp_type: str = "swiglu"         # swiglu | gelu | rwkv_cmix
    norm_type: str = "rmsnorm"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "a2a"        # a2a (dense on one device) | sort | cumsum
    kv_cache_dtype: str = "compute"  # compute | int8 (per-token-head scales)
    # hybrid / recurrent
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled over layers
    d_rnn: int = 0
    local_window: int = 0            # 0 -> full attention
    conv_width: int = 4
    modality: str = "text"           # text | vision_stub | audio_stub
    n_prefix_embeds: int = 0         # vision_stub: # of patch embeddings
    rope_theta: float = 1e4
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    attn_chunk_q: int = 1024
    attn_chunk_threshold: int = 8192
    sub_quadratic: bool = False
    tag: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests (the reference's
        ``reduced()``)."""
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
            d_ff_expert=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=256,
            d_rnn=128 if self.d_rnn else 0,
            local_window=min(self.local_window, 64) if self.local_window
            else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 4),
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


# ---------------------------------------------------------------- run config

@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One training run (port of the reference's ``RunConfig``; its fields
    and defaults, less those of what the port leaves out).

    Reliability is policy-native: hand a
    :class:`repro_torch.core.deployment.ReliabilityPolicy` to ``policy``
    (with ``ber``/``inject`` for the fault schedule). ``exp_reg_coef`` turns
    on the exponent-compression regularizer; ``freeze_exponents=False``
    skips alignment and the frozen (exponent, sign) projection even when the
    policy is on.

    A non-empty ``checkpoint_dir`` saves the training state there every
    ``checkpoint_every`` steps and at the end, and a later run resumes from
    its latest step; ``grad_compression`` compresses the gradient to int8
    with error feedback.

    ``remat`` (default True, as the reference's) recomputes each layer
    group's forward in the backward instead of keeping its activations
    and, on a sharded state, its gathered leaves
    (:func:`repro_torch.models.lm.forward_blocks`); the step is bitwise the
    same either way.

    Left out: the reference's deprecated ``reliability=`` surface, the
    descriptive ``arch`` and ``shape`` (the model comes as a ModelConfig),
    and ``multi_pod`` and ``seq_shard``, which come back with the slices
    that act on them.
    """

    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    grad_compression: bool = False
    straggler_factor: float = 3.0
    policy: Optional[object] = None        # ReliabilityPolicy
    ber: float = 0.0
    inject: str = "dynamic"                # static | dynamic
    exp_reg_coef: float = 0.0
    exp_reg_margin: float = 1.0
    freeze_exponents: bool = True
    remat: bool = True

    def __post_init__(self):
        if self.policy is not None:
            from repro_torch.core import deployment as dep_lib
            if not isinstance(self.policy, dep_lib.ReliabilityPolicy):
                raise TypeError(f"RunConfig: policy must be a "
                                f"ReliabilityPolicy, got "
                                f"{type(self.policy).__name__}")
        if self.ber < 0:
            raise ValueError(f"RunConfig: ber must be >= 0, got {self.ber}")
        if self.checkpoint_every < 1:
            raise ValueError(f"RunConfig: checkpoint_every must be >= 1, "
                             f"got {self.checkpoint_every}")
        if self.inject not in ("static", "dynamic"):
            raise ValueError(f"RunConfig: inject must be 'static' or "
                             f"'dynamic', got {self.inject!r}")

    @property
    def rel(self):
        """The resolved :class:`~repro_torch.core.api.ReliabilityConfig`:
        the policy compiled by ``from_policy`` (mode 'cim', also at ber 0),
        else the inert default."""
        from repro_torch.core.api import ReliabilityConfig
        if self.policy is not None:
            return ReliabilityConfig.from_policy(self.policy, ber=self.ber,
                                                 inject=self.inject)
        return ReliabilityConfig()
