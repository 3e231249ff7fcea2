"""Command-R 35B: GQA, no-bias dense transformer.

[hf:CohereForAI/c4ai-command-r-v01; unverified] — 40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab_size=256000,
        mlp_type="swiglu", norm_type="layernorm",
        rope_theta=8e6,
        tag="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
    )
