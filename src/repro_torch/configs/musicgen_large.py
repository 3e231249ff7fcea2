"""MusicGen-large: decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] — 48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192
vocab=2048. The EnCodec frontend is a STUB: input_specs provide precomputed
frame embeddings; decode embeds generated audio tokens.
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="musicgen-large", family="dense",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048,
        mlp_type="gelu", norm_type="layernorm",
        modality="audio_stub",
        tag="[arXiv:2306.05284; hf]",
    )
