"""CodeQwen1.5-7B: qwen1.5 architecture.

[hf:Qwen/CodeQwen1.5-7B; hf] — 32L d_model=4096 32H (GQA kv=32... listed MHA)
d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig, register


@register("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416,
        mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=1e6,
        tag="[hf:Qwen/CodeQwen1.5-7B; hf]",
    )
