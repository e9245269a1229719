"""Importing this package registers the architectures the port serves."""
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    granite_8b,
    h2o_danube_1_8b,
    llama4_scout_17b_a16e,
    nemotron_4_15b,
    olmoe_1b_7b,
    qwen2_1_5b,
    rwkv6_3b,
    whisper_large_v3,
    zamba2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_applicable,
    get_config,
    list_configs,
    reduced,
)
