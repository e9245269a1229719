"""Serving: page allocator and radix prefix cache, block-paged KV pool,
greedy engine with self-speculative decode."""
from repro_torch.serving.allocator import (PageAllocator,  # noqa: F401
                                           PoolExhausted, RadixPrefixCache)
from repro_torch.serving.engine import Engine, Request, Result  # noqa: F401
