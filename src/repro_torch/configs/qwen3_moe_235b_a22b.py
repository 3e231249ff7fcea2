"""Qwen3-MoE 235B-A22B: 128 experts, top-8, GQA kv=4.

[hf:Qwen/Qwen3-30B-A3B; hf] — 94L d_model=4096 64H (GQA kv=4)
d_ff_expert=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936,
        n_experts=128, top_k=8, d_ff_expert=1536,
        mlp_type="swiglu", norm_type="rmsnorm",
        block_pattern=("moe",),
        rope_theta=1e6,
        tag="[hf:Qwen/Qwen3-30B-A3B; hf]",
    )
