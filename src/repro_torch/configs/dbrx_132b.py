"""DBRX 132B: fine-grained MoE, 16 experts top-4, GQA kv=8.

[hf:databricks/dbrx-base; unverified] — 40L d_model=6144 48H (GQA kv=8)
d_ff_expert=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ModelConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        n_experts=16, top_k=4, d_ff_expert=10752,
        mlp_type="swiglu", norm_type="layernorm",
        block_pattern=("moe",),
        rope_theta=5e5,
        tag="[hf:databricks/dbrx-base; unverified]",
    )
