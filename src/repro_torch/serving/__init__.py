"""Serving: page allocator and radix prefix cache, block-paged KV pool,
greedy engine with self-speculative decode, the stream scheduler, fault
injection, and data-parallel replicas with failover."""
from repro_torch.common.transient import TransientError, is_transient  # noqa: F401
from repro_torch.serving.allocator import (PageAllocator,  # noqa: F401
                                           PoolExhausted, RadixPrefixCache)
from repro_torch.serving.engine import Engine, Request, Result  # noqa: F401
from repro_torch.serving.faults import (FAULT_ENV,  # noqa: F401
                                        FaultInjector, FaultPlan,
                                        InjectedFault)
from repro_torch.serving.replica import ReplicaSet  # noqa: F401
from repro_torch.serving.scheduler import (QueueFull,  # noqa: F401
                                           SchedulerConfig, StreamScheduler,
                                           WatchdogError)
