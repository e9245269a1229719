"""Where a decode step's time goes: torch.profiler over steady decode.

    python -m repro_torch.launch.profile_decode --arch qwen2-1.5b \\
        --horizon 1 4 --eager

serves ``--requests`` seeded random prompts of 200-1000 tokens (the
traffic of ``chip_smoke.py``) at full width on the card, runs three
engine steps to warm up (admission and the decode graph's capture
happen in the first), then profiles ``--steps`` engine steps, for each
``--horizon`` (decode steps per engine step and host sync) on the
engine's CUDA graph and, with ``--eager``, on the same engine stepping
op by op (``cuda_graph=False``), all in one process on one set of
weights. The same number of steps runs first without the profiler, for
the wall time and tok/s it does not slow. Prints one JSON line per run,
per token step (one decode step of the whole batch): wall time (with
and without the profiler), device busy time (the sum of kernel
time), the device's idle share, kernels (also by group: GEMMs,
elementwise, index, sort, reduce, copies, the FUM kernels), the FUM
kernel's time (split pass and merge) and launches, the top kernels by
device time, the top operators by host time and (eager runs) by the
device time of the kernels they launched; with the card's name and
power limit. ``--trace PREFIX`` also writes each run's Chrome trace.
``--kv-dtype``, ``--kv-scale``, ``--layout`` and ``--no-hdp`` pick the
cache and the attention as ``launch/serve.py``'s flags of the same names
do.

    python -m repro_torch.launch.profile_decode --spec-decode --draft-len 4

profiles self-speculative rounds instead of decode horizons (an engine
step is one round: ``draft_len - 1`` draft steps and one multi-query
verify, one CUDA graph per round width): per round, the wall and device
busy time, the kernels and the FUM kernel's launches, the tokens
committed and the acceptance rate; the round's device time split into
the draft steps and the verify comes from the same rounds run eagerly,
whose kernels fall inside the engine's "spec_draft" and "spec_verify"
profiler ranges (a graph's replay shows no ranges).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--horizon", type=int, nargs="+", default=[1])
    ap.add_argument("--eager", action="store_true",
                    help="also profile the engine stepping eagerly")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "fp32", "int8", "fp8_v"])
    ap.add_argument("--kv-scale", default="grid", choices=["grid", "absmax"])
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "paged", "dense"])
    ap.add_argument("--no-hdp", action="store_true")
    ap.add_argument("--spec-decode", action="store_true",
                    help="profile self-speculative rounds (with --eager: "
                         "also eagerly, which splits draft from verify)")
    ap.add_argument("--draft-len", type=int, default=4)
    return ap.parse_args(argv)


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: kernel groups of the breakdown, by a substring of the kernel's name
#: (the first match wins; "other" takes the rest)
GROUPS = (("fum", "fum_"), ("gemm", "nvjet"), ("gemm", "gemm"),
          ("sort", "sort"), ("reduce", "reduce_kernel"),
          ("index", "index"), ("index", "scatter"), ("index", "gather"),
          ("elementwise", "elementwise_kernel"), ("copy", "copy"))


def group_of(name: str) -> str:
    return next((g for g, key in GROUPS if key in name), "other")


#: the engine's profiler ranges of a speculative round's two parts
SPEC_RANGES = ("spec_draft", "spec_verify")


def range_split(prof) -> dict:
    """Device time (ms) of the kernels inside each of ``SPEC_RANGES``'
    device-side spans, and their counts: an eager run's split of a
    round into its draft steps and its verify."""
    from torch.autograd import DeviceType
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in evts
             if e.name in SPEC_RANGES]
    out = {name: {"ms": 0.0, "kernels": 0} for name in SPEC_RANGES}
    for e in evts:
        if e.name in SPEC_RANGES:
            continue
        t = e.time_range.start
        for name, a, b in spans:
            if a <= t < b:
                out[name]["ms"] += (e.time_range.end - t) / 1e3
                out[name]["kernels"] += 1
                break
    return out


def profile_run(args, cfg, params, horizon: int, graph: bool) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.attention import AttnSpec
    from repro_torch.serving import Engine, Request

    warmup, top = 3, 12
    spec = args.spec_decode
    per_step = args.draft_len if spec else horizon   # tokens a step at most
    max_new = (warmup + 2 * args.steps) * per_step + 1
    buckets = (256, 512, 1024)
    eng = Engine(cfg, params, device="cuda", max_batch=args.requests,
                 max_len=buckets[-1] + max_new, prefill_buckets=buckets,
                 decode_horizon=horizon, cuda_graph=graph,
                 spec_decode=spec, draft_len=args.draft_len,
                 attn=AttnSpec(layout=args.layout, kv_dtype=args.kv_dtype,
                               kv_scale=args.kv_scale))
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        n = int(rng.integers(200, 1001))
        eng.submit(Request(uid, rng.integers(1, cfg.vocab_size, n).tolist(),
                           max_new_tokens=max_new))
    for _ in range(warmup):
        eng.step()
    # the same number of steps first without the profiler (its tracing
    # adds host time to every launch, graph launches included)
    torch.cuda.synchronize()
    m0 = dict(eng.metrics)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    # the unit of the per-step numbers: a token step (one decode step of
    # the whole batch), or with --spec-decode a round
    unit = "spec_rounds" if spec else "decode_steps"
    n_plain = eng.metrics[unit] - m0[unit]
    plain_tok = eng.metrics["tokens_out"] - m0["tokens_out"]
    m0 = dict(eng.metrics)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mode = "graph" if graph else "eager"
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}-{mode}-h{horizon}.json")
    n_tok = eng.metrics[unit] - m0[unit]
    done = {m: eng.metrics[m] - m0[m] for m in
            ("tokens_out", "draft_tokens", "accepted_tokens")}
    avgs = prof.key_averages()
    # device rows are the kernels themselves (host operator rows also
    # carry the time of the kernels they launched: counting both doubles)
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type == DeviceType.CPU]

    def dev_us(e):
        return e.self_device_time_total

    busy_us = sum(dev_us(e) for e in kernels)
    fum = [e for e in kernels if "fum_" in e.key]
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:top]
    by_op = sorted(host, key=lambda e: e.self_device_time_total,
                   reverse=True)[:top]
    groups = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key), [0.0, 0.0])
        g[0] += e.count / n_tok
        g[1] += dev_us(e) / 1e3 / n_tok
    out = {
        "device": torch.cuda.get_device_name(0), "card": card(),
        "arch": args.arch, "batch": args.requests, "mode": mode,
        "hdp": not args.no_hdp, "layout": args.layout,
        "kv_dtype": eng.kv_dtype, "kv_scale": eng.kv_scale,
        "attn_backend_decode": eng.resolved_backend("decode"),
        "horizon": horizon, "engine_steps": args.steps, "token_steps": n_tok,
        "unprofiled_wall_ms_per_token_step": 1e3 * wall_plain / n_plain,
        "unprofiled_decode_tok_s": plain_tok / wall_plain,
        "wall_ms_per_token_step": 1e3 * wall / n_tok,
        "decode_tok_s": done["tokens_out"] / wall,
        "device_busy_ms_per_token_step": busy_us / 1e3 / n_tok,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_token_step": sum(e.count for e in kernels) / n_tok,
        "fum_kernel_ms_per_token_step": sum(map(dev_us, fum)) / 1e3 / n_tok,
        "fum_kernels_per_token_step": {e.key[:60]: e.count / n_tok
                                       for e in fum},
        "fum_launches_per_token_step": (eng.metrics["fum_kernel_launches"]
                                        - m0["fum_kernel_launches"]) / n_tok,
        "graph_reserved_bytes": eng.metrics["graph_reserved_bytes"],
        "graph_captures": eng.metrics["graph_captures"],
        "kernel_groups_per_token_step": {
            g: {"kernels": n, "ms": ms} for g, (n, ms) in
            sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top_device_ms_per_token_step": [
            [e.key[:100], dev_us(e) / 1e3 / n_tok] for e in by_dev],
        "top_host_ms_per_token_step": [
            [e.key[:100], e.self_cpu_time_total / 1e3 / n_tok]
            for e in by_host],
        # eager runs only (a graph's replay shows no operators): the
        # device time of the kernels each operator launched itself, e.g.
        # aten::bmm (the MoE's expert products) against aten::mm
        "top_ops_device_ms_per_token_step": [
            [e.key[:100], e.self_device_time_total / 1e3 / n_tok,
             e.count / n_tok] for e in by_op if e.self_device_time_total],
    }
    if spec:
        # every "per_token_step" number above is per round here
        out.update({
            "spec_decode": True, "draft_len": args.draft_len,
            "step_unit": "round",
            "attn_backend_draft": eng.resolved_backend("draft"),
            "attn_backend_verify": eng.resolved_backend("verify"),
            "tokens_per_round": done["tokens_out"] / n_tok,
            "acceptance_rate": (done["accepted_tokens"] / done["draft_tokens"]
                                if done["draft_tokens"] else 0.0),
            "round_launches": eng.summary()["round_launches"],
        })
        if not graph:
            split = range_split(prof)
            out["device_ms_per_round_by_part"] = {
                name: {"ms": v["ms"] / n_tok, "kernels": v["kernels"] / n_tok}
                for name, v in split.items()}
    del eng
    torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry

    if not torch.cuda.is_available():
        print("profile_decode needs a CUDA card", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    params = registry.init_params(cfg, args.seed, "cuda")
    if args.no_hdp and cfg.hdp is not None:
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    with torch.inference_mode():
        for horizon in ([1] if args.spec_decode else args.horizon):
            for graph in ((False, True) if args.eager else (True,)):
                print(json.dumps(profile_run(args, cfg, params, horizon,
                                             graph)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
