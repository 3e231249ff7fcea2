"""OLMo-1B: dense, non-parametric LayerNorm (no learnable scale/bias).

[arXiv:2402.00838; hf] — 16L d_model=2048 16H (MHA) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, register


@register("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        mlp_type="swiglu", norm_type="nonparametric_ln",
        tag="[arXiv:2402.00838; hf]",
    )
