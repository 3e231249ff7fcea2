"""RecurrentGemma-9B (Griffin): RG-LRU recurrent blocks + local attention, 1:2.

[arXiv:2402.19427; unverified] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, window 2048. Pattern (rec, rec, local) cycled; sub-quadratic ->
runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000,
        mlp_type="gelu", norm_type="rmsnorm",
        block_pattern=("rec", "rec", "local"),
        d_rnn=4096, local_window=2048,
        sub_quadratic=True,
        tag="[arXiv:2402.19427; unverified]",
    )
