"""RWKV6 "Finch" 1.6B: attention-free, data-dependent decay.

[arXiv:2404.05892; unverified] — 24L d_model=2048 d_ff=7168 vocab=65536.
Head size 64 -> 32 rwkv heads. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=7168, vocab_size=65536,
        mlp_type="rwkv_cmix", norm_type="layernorm",
        block_pattern=("rwkv",),
        sub_quadratic=True,
        tag="[arXiv:2404.05892; unverified]",
    )
