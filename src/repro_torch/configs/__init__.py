"""Importing this package registers the architectures the port serves."""
from repro_torch.configs import qwen2_1_5b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    reduced,
)
