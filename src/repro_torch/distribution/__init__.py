"""Distributed helpers: gradient compression, the logical-axis sharding
rules, and tensor-parallel serving over ``torch.distributed``."""
from repro_torch.distribution.collectives import (  # noqa: F401
    compress_grads_bf16,
    maybe_compress,
)
from repro_torch.distribution.sharding import (  # noqa: F401
    RULES_FSDP_TP,
    RULES_TP,
    Mesh,
    PartitionSpec,
    logical_axis_rules,
    shard_activation,
    spec_for,
    tree_specs,
    zero1_spec,
)
from repro_torch.distribution.tp import (  # noqa: F401
    active_serving_mesh,
    active_tp,
    pool_pspec,
    pool_shardings,
    serving_mesh,
    tp_paged_attention,
)
