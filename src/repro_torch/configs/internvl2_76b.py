"""InternVL2-76B backbone: InternLM2-76B decoder (+ InternViT patch stub).

[arXiv:2404.16821; unverified] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. The vision frontend is a STUB per the assignment: input_specs
provide 256 precomputed patch embeddings prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-76b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-76b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        mlp_type="swiglu", norm_type="rmsnorm",
        modality="vision_stub", n_prefix_embeds=256,
        rope_theta=1e6,
        tag="[arXiv:2404.16821; unverified]",
    )
