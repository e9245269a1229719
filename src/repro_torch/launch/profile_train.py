"""Where the train step's time goes: torch.profiler over one step.

    python -m repro_torch.launch.profile_train --arch qwen2-1.5b

builds the launcher's train step (``launch.steps.build_train_step``:
``micro_batches`` of the shape, fp32 gradient accumulators, AdamW) on
seeded random weights and a synthetic batch of ``--global-batch`` rows
of ``--seq`` tokens, runs one step to warm up and then one under the
profiler, and prints one JSON line: the step's wall time, the device's
busy time and idle share, the kernel count, the peak memory, the device
time by kernel group (GEMMs on the tensor cores and on the CUDA cores,
elementwise, reductions, copies and indexing, the rest) and the top
kernels by device time. It needs a CUDA card; TF32 stays off, as on
every parity run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence


#: kernel-name groups, first match wins: the CUDA-core (fp32, TF32 off)
#: GEMMs, the other GEMMs (bf16 on the tensor cores), then the rest
GROUPS = (
    ("gemm fp32 (CUDA cores)", ("sgemm", "f32f32_f32f32", "gemm_f32")),
    ("gemm (tensor cores)", ("gemm", "nvjet", "xmma", "cutlass", "wgmma")),
    ("reduce", ("reduce_kernel", "softmax", "logsumexp", "norm")),
    ("copy, cat, index", ("copy", "cat", "index", "gather", "scatter",
                          "fill")),
    ("elementwise", ("elementwise",)),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    shape = ShapeConfig("train_4k", args.seq, args.global_batch, "train")
    built = build_train_step(cfg, shape)
    params = registry.init_params(cfg, args.seed, "cuda")
    state = opt.init_opt_state(params)
    src = make_source(DataConfig(cfg.vocab_size, args.seq,
                                 args.global_batch, seed=args.seed))

    def batch(step):
        return {"tokens": torch.as_tensor(src.batch_at(step), device="cuda")}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, _ = built.fn(params, state, batch(0))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    b = batch(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = built.fn(params, state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups: Dict[str, float] = {}
    for e in kernels:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    by_dev = sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": args.arch,
        "seq": args.seq, "global_batch": args.global_batch,
        "microbatches": built.meta["num_microbatches"],
        "params": registry.param_count(cfg),
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "warmup_step_s": warm, "step_s": wall,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels": sum(e.count for e in kernels),
        "peak_mem_gb": peak / 1e9,
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "top_device_ms": [[e.key[:120], e.self_device_time_total / 1e3,
                           e.count, group_of(e.key)] for e in by_dev],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
