"""Granite-3 8B: GQA dense transformer.

[hf:ibm-granite/granite-3.0-2b-base; hf] — 40L d_model=4096 32H (GQA kv=8)
d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155,
        mlp_type="swiglu", norm_type="rmsnorm",
        tag="[hf:ibm-granite/granite-3.0-2b-base; hf]",
    )
