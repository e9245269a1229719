"""Serving: page allocator, int8 block-paged KV pool, greedy engine."""
from repro_torch.serving.engine import Engine, Request, Result  # noqa: F401
