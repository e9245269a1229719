"""Where the aligned prefill's time goes: torch.profiler over the paper's
full-sequence pipeline.

    python -m repro_torch.launch.profile_prefill --arch qwen2-1.5b

runs ``registry.apply_prefill(cfg, params, {"tokens": t}, None)`` on
seeded random weights and token ids (B ``--batch``, S ``--seq``), with
HDP on (scout + block-sparse kernels) and off (flash), each once to warm
up and then ``--runs`` times under the profiler, and prints one JSON
line per setting: the wall time per prefill, the device's busy time (the
sum of kernel time) and idle share, the launches of each attention
kernel per path, and the top kernels by device time. With ``--walls``
it takes no profile: each of the ``--runs`` prefills is timed alone on
the host clock (ending in a synchronize), and the JSON line gives every
wall and their median, for A/Bs of two checkouts on one card (the
profiler slows a prefill of many small kernels, such as zamba2-7b's,
several times over, and reading its events takes minutes).

    python -m repro_torch.launch.profile_prefill --arch granite-8b --serving

profiles the serving engine's prefill instead (``Engine``'s admission,
plain PyTorch ``xla_hdp`` into a request cache): the bucketed prefill of
``--requests`` seeded prompts of 256-4,096 tokens (buckets 1,024, 2,048
and 4,096), then the chunked prefill of one ``--long``-token prompt in
1,024-token chunks, each once to warm up on its own engine and then once
under the profiler; one JSON line per mode with the wall time, device
busy time and idle share, the kernel count, and the top operators by
device and by host time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--walls", action="store_true",
                    help="time each prefill without the profiler")
    ap.add_argument("--serving", action="store_true",
                    help="profile the serving engine's bucketed and "
                         "chunked prefill instead")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--long", type=int, default=4000)
    return ap.parse_args(argv)


def profile_admission(args, cfg, params, top: int = 10) -> None:
    """The engine's admission (its prefill and the install into the
    pool) of each mode, warmed up once on its own engine, then profiled
    once on a fresh one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, Request

    rng = np.random.default_rng(args.seed + 17)
    lens = [int(n) for n in rng.integers(256, 4097, size=args.requests)]
    modes = {
        "bucketed": (dict(max_batch=args.requests, max_len=4096 + 32,
                          prefill_buckets=(1024, 2048, 4096)), lens),
        "chunked": (dict(max_batch=1, max_len=args.long + 32,
                         prefill_buckets=(256, 512, 1024)), [args.long]),
    }
    for mode, (kw, plens) in modes.items():
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in plens]
        for profiled in (False, True):
            eng = Engine(cfg, params, device="cuda", **kw)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid, p, max_new_tokens=8))
            torch.cuda.synchronize()
            if not profiled:
                eng._admit()
                torch.cuda.synchronize()
                del eng
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng._admit()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in kernels)
            by_dev = sorted(kernels, key=lambda e: e.self_device_time_total,
                            reverse=True)[:top]
            by_host = sorted(
                (e for e in events if e.device_type == DeviceType.CPU),
                key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
            s = eng.summary()
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "arch": args.arch,
                "mode": mode, "prompt_lens": plens,
                "prefill_calls": s["prefill_calls"],
                "prefill_tokens": s["prefill_tokens"],
                "attn_backend_prefill": s["attn_backend_prefill"],
                "wall_ms": 1e3 * wall, "prefill_s": s["prefill_s"],
                "device_busy_ms": busy_us / 1e3,
                "device_idle_share": 1.0 - busy_us / 1e6 / wall,
                "kernels": sum(e.count for e in kernels),
                "top_device_ms": [[e.key[:100], e.self_device_time_total
                                   / 1e3, e.count] for e in by_dev],
                "top_host_ms": [[e.key[:100], e.self_cpu_time_total / 1e3,
                                 e.count] for e in by_host],
            }), flush=True)
            del eng


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.models import registry

    if not torch.cuda.is_available():
        raise SystemExit("profile_prefill needs a CUDA card")
    cfg = get_config(args.arch)
    params = registry.init_params(cfg, args.seed, "cuda")
    if args.serving:
        with torch.inference_mode():
            profile_admission(args, cfg, params)
        return 0
    toks = torch.from_numpy(np.random.default_rng(args.seed + 5).integers(
        1, cfg.vocab_size, (args.batch, args.seq))).cuda()
    top = 10
    wrappers = (hdp_scout, hdp_block_sparse_attention, flash_attention)
    with torch.inference_mode():
        for hdp_on in (True, False):
            c = cfg.replace(hdp=cfg.hdp.replace(enabled=hdp_on))
            registry.apply_prefill(c, params, {"tokens": toks}, None)
            torch.cuda.synchronize()
            for fn in wrappers:
                fn.launches = 0
                fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
            walls = []
            ctx = contextlib.nullcontext() if args.walls else profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with ctx as prof:
                t_start = time.perf_counter()
                for _ in range(args.runs):
                    t0 = time.perf_counter()
                    registry.apply_prefill(c, params, {"tokens": toks}, None)
                    if args.walls:
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_start
            out = {
                "device": torch.cuda.get_device_name(0),
                "arch": args.arch, "batch": args.batch, "seq": args.seq,
                "hdp": hdp_on, "runs": args.runs,
                "wall_ms_per_prefill": 1e3 * wall / args.runs,
                "launches_per_prefill": {
                    fn.__name__: {p: n / args.runs for p, n in
                                  fn.launches_by_path.items()}
                    for fn in wrappers}}
            if args.walls:
                out["wall_ms"] = [1e3 * w for w in walls]
                out["wall_ms_median"] = 1e3 * float(np.median(walls))
            else:
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                busy_us = sum(e.self_device_time_total for e in kernels)
                by_dev = sorted(kernels,
                                key=lambda e: e.self_device_time_total,
                                reverse=True)[:top]
                out["device_busy_ms_per_prefill"] = busy_us / 1e3 / args.runs
                out["device_idle_share"] = 1.0 - busy_us / 1e6 / wall
                out["top_device_ms_per_prefill"] = [
                    [e.key[:100], e.self_device_time_total / 1e3 / args.runs,
                     e.count / args.runs] for e in by_dev]
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
