"""The paper's own benchmark family, reduced to container scale.

The paper evaluates ResNet18 / YOLOv5 / nnUNet / TinyViT; `tinyvit-paper` is
a small ViT-style transformer, and the CNN lives in repro_torch.models.cnn
(the Fig. 2 sweep's model).
"""
from repro_torch.configs.base import ModelConfig, register


@register("tinyvit-paper")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="tinyvit-paper", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512,
        mlp_type="gelu", norm_type="layernorm",
        tag="[paper benchmark family; reduced]",
    )
