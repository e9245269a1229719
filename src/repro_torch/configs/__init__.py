"""Importing this package registers the architectures the port serves."""
from repro_torch.configs import granite_8b, h2o_danube_1_8b, qwen2_1_5b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    reduced,
)
