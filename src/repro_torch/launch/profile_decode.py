"""Where a decode step's time goes: torch.profiler over steady decode.

    python -m repro_torch.launch.profile_decode --arch qwen2-1.5b

serves ``--requests`` seeded random prompts of 200-1000 tokens (the
traffic of ``chip_smoke.py``) at full width on the card, runs three
decode steps to warm up (admission happens in the first), then profiles
``--steps`` steps and
prints one JSON line: wall time per step, device busy time per step (the
sum of kernel time), the device's idle share, the FUM kernel's share
(its split pass and merge) and launches per mode, and the top operators
by device time and by host time. ``--trace PATH``
also writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.serving import Engine, Request

    cfg = get_config(args.arch)
    warmup, top = 3, 12
    max_new = warmup + args.steps + 1
    buckets = (256, 512, 1024)
    eng = Engine(cfg, seed=args.seed, device="cuda",
                 max_batch=args.requests,
                 max_len=buckets[-1] + max_new, prefill_buckets=buckets)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        n = int(rng.integers(200, 1001))
        eng.submit(Request(uid, rng.integers(1, cfg.vocab_size, n).tolist(),
                           max_new_tokens=max_new))
    for _ in range(warmup):
        eng.step()
    torch.cuda.synchronize()
    hdp_paged_fum_decode.launches_by_path = dict.fromkeys(
        hdp_paged_fum_decode.launches_by_path, 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    # device rows are the kernels themselves (host operator rows also
    # carry the time of the kernels they launched: counting both doubles)
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type == DeviceType.CPU]

    def dev_us(e):
        return e.self_device_time_total

    busy_us = sum(dev_us(e) for e in kernels)
    fum_us = sum(dev_us(e) for e in kernels if "fum_" in e.key)
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:top]
    n_kernels = sum(e.count for e in kernels)
    out = {
        "device": torch.cuda.get_device_name(0),
        "arch": args.arch, "batch": args.requests, "steps": args.steps,
        "wall_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "fum_kernel_ms_per_step": fum_us / 1e3 / args.steps,
        "fum_launches_per_step": {
            m: n / args.steps
            for m, n in hdp_paged_fum_decode.launches_by_path.items()},
        "device_ops_per_step": n_kernels / args.steps,
        "top_device_ms_per_step": [[e.key[:100], dev_us(e) / 1e3 / args.steps]
                                   for e in by_dev],
        "top_host_ms_per_step": [[e.key[:100], e.self_cpu_time_total / 1e3
                                  / args.steps] for e in by_host],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
