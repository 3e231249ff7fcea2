# Architecture registry: importing this package registers the ported archs.
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    command_r_35b,
    dbrx_132b,
    granite_3_8b,
    internvl2_76b,
    musicgen_large,
    olmo_1b,
    qwen3_moe_235b_a22b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    unicorn_paper,
)
from repro_torch.configs.base import ModelConfig, RunConfig, get_config  # noqa: F401
