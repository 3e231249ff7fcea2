# Architecture registry: importing this package registers the ported archs.
from repro_torch.configs import olmo_1b  # noqa: F401
from repro_torch.configs.base import ModelConfig, RunConfig, get_config  # noqa: F401
