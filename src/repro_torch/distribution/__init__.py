"""Distributed-optimization helpers. Only the gradient compression is
ported so far; the sharding rules, tensor parallelism and the mesh
follow (ROADMAP.md section 1, item 8)."""
from repro_torch.distribution.collectives import (  # noqa: F401
    compress_grads_bf16,
    maybe_compress,
)
