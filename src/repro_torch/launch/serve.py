"""Serve seeded random prompts through the port's engine and print its
summary as one JSON line.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8 --max-new 32

runs on the CUDA card (the default ``--device cuda`` raises without
one); ``--device cpu --reduced`` serves the tiny test-size config
through the plain kernel versions. ``--backend`` picks the attention
backend (a registry name or family tag, e.g. ``pallas_hdp_block`` for
the block-sparse kernel in decode; default ``auto``);
``--decode-horizon`` sets the engine's decode steps per host sync.
``--layout`` picks the paged pool (the default) or the dense slot cache,
``--kv-dtype`` the pool format (int8, fp8_v, or fp32: unquantized pages
in the model dtype) and ``--kv-scale`` its scales (grid or absmax);
``--no-hdp`` serves the same model with exact attention.
``--prefix-cache`` shares prompt-prefix pages through the radix tree
(``--shared-prefix N`` gives every prompt a common random prefix of N
tokens, ``--num-pages`` sizes the pool); ``--spec-decode`` serves by
self-speculative rounds of ``--draft-len`` tokens. ``--stream-sched``
serves through the continuous-batching stream scheduler (token-budget
admission, mid-run slot recycling, chunked prefill interleaved with
decode, ``--prefill-chunk`` tokens a step, a watchdog after
``--watchdog-steps`` idle steps); with ``--arrival-rate R`` the requests
arrive as a seeded Poisson stream of R a step on the engine's step
clock (``poisson_arrivals``), drawn after the prompts, so the prompts
and the tokens are the static run's. The summary then grows the
scheduler's counters, TTFT, TPOT and the queue's wait and depth.
``--fault-plan`` injects a deterministic schedule of faults
(``kind@step[:k=v,..];...``, kinds exhaust, error, nan, slow and kill;
``serving.faults``), and ``--dp N`` serves through N engine replicas
sharing one set of weights on the card (``serving.replica.ReplicaSet``:
prefix-affinity then least-loaded dispatch, failover of a dead
replica's requests); its summary is replica 0's with the fleet's
throughput and counters, health and failovers. ``--policy cost`` ranks
the auto backends through the cost model under the device's hardware
profile (``repro_torch.autotune``; ambiguous calls probed once, on the
card), ``--tuner-cache PATH`` loads the tuner's measured cache before
serving and saves it after, and ``--adaptive-spec`` (with
``--spec-decode``) lets an acceptance-rate EMA plan each round's draft
length and draft thresholds; the summary grows ``attn_policy``, the
tuner's counters, ``pred_decode_step_s`` beside ``meas_decode_step_s``,
and ``acceptance_ema``/``draft_len_mean``. Each defaults to its REPRO_*
environment variable, as in the reference.
Weights are random, drawn from ``--seed``; prompt lengths are drawn
from [bucket/4, max_len - max_new] with the largest prefill bucket
(1024, or 32 with ``--reduced``; longer prompts prefill in chunks), and
``--max-len`` defaults to that bucket plus ``--max-new``.

    python -m repro_torch.launch.serve --arch granite-8b --kv-dtype fp8_v
    python -m repro_torch.launch.serve --prefix-cache --shared-prefix 512 \
        --spec-decode --draft-len 4
    python -m repro_torch.launch.serve --stream-sched --arrival-rate 0.5
    python -m repro_torch.launch.serve --dp 2 --stream-sched \
        --fault-plan "nan@2:uid=3;kill@4:replica=0"
    python -m repro_torch.launch.serve --policy cost --tuner-cache t.json
    python -m repro_torch.launch.serve --spec-decode --adaptive-spec
    python -m repro_torch.launch.serve --arch zamba2-7b --decode-horizon 4

``--tp N`` serves tensor-parallel: run it under ``torchrun
--nproc-per-node N`` (the ranks join one gloo process group, or NCCL
with a card per rank), and every rank serves the same requests with
1/N of the pool's KV heads, gathering each decode layer's attention
output exactly, so the tokens are those of ``--tp 1``; the decode steps
eagerly (a CUDA graph is refused at tp > 1) and rank 0 prints the
summary, with ``tp``, ``mesh_shape``, ``cache_bytes_pool_per_shard`` and
``collective_bytes_per_layer``:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --reduced --tp 2

``--arch rwkv6-3b`` and ``--arch zamba2-7b`` serve the recurrent
families from the dense layout, each prompt prefilled at its exact
length; ``--arch whisper-large-v3`` raises NotImplementedError, as the
engine refuses encoder-decoder configs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> np.ndarray:
    """Arrival steps of ``n`` requests: the floor of the running sum of
    exponential gaps of mean ``1/rate`` steps (the reference traffic
    generator's Poisson rule, ``benchmarks/traffic.py``)."""
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(int)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny reduced() config of --arch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    help="attention backend: a registry name, a family "
                         "tag (pallas | xla | reference) or auto")
    ap.add_argument("--decode-horizon", type=int, default=None,
                    help="decode steps per engine step and host sync "
                         "(one CUDA graph replay each on the card), "
                         "token-identical to 1; default honors "
                         "REPRO_DECODE_HORIZON, else 1")
    ap.add_argument("--max-len", type=int, default=None,
                    help="longest prompt + generation a slot holds")
    ap.add_argument("--no-hdp", action="store_true",
                    help="serve with exact attention (HDP off)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "paged", "dense"],
                    help="serving cache layout: the block-paged pool "
                         "(auto) or the dense per-slot cache")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "fp32", "int8", "fp8_v"],
                    help="paged pool format: int8 codes, int8 K + fp8 V, "
                         "or unquantized pages in the model dtype (fp32); "
                         "auto honors REPRO_KV_DTYPE, else int8")
    ap.add_argument("--kv-scale", default="grid", choices=["grid", "absmax"],
                    help="quantized pool scales: the static power-of-two "
                         "grid or per-page absmax")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: one full table per "
                         "slot plus the scratch page)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None,
                    help="share prompt-prefix pages across requests through "
                         "the radix tree (paged layout); prefill runs only "
                         "on the unshared suffix. Default honors "
                         "REPRO_PREFIX_CACHE, else off")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="force prefix caching off (the cold A/B leg)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every prompt a common random prefix of this "
                         "many tokens (the prefix cache's traffic); 0: "
                         "fully random prompts")
    ap.add_argument("--spec-decode", dest="spec_decode",
                    action="store_true", default=None,
                    help="self-speculative decode: per round, draft-len - 1 "
                         "draft steps on the int8 scout copies and one "
                         "multi-query verify; the tokens of plain greedy "
                         "decode. Default honors REPRO_SPEC_DECODE, else "
                         "off")
    ap.add_argument("--no-spec-decode", dest="spec_decode",
                    action="store_false",
                    help="force speculative decode off (the A/B baseline)")
    ap.add_argument("--draft-len", type=int, default=None,
                    help="tokens proposed and verified per round; default "
                         "honors REPRO_DRAFT_LEN, else 4")
    ap.add_argument("--policy", default=None, choices=["static", "cost"],
                    help="auto-selection policy for the attention backend: "
                         "static = registry priority order; cost = the "
                         "repro_torch.autotune cost model ranks candidates "
                         "under the device's hardware profile (probing "
                         "ambiguous calls once). Default honors "
                         "REPRO_ATTN_POLICY, else static")
    ap.add_argument("--tuner-cache", default=None,
                    help="JSON path for the cost-policy tuner's measured "
                         "cache: loaded before serving (warm start) and "
                         "written back after, so repeat runs skip probes")
    ap.add_argument("--adaptive-spec", dest="adaptive_spec",
                    action="store_true", default=None,
                    help="acceptance-adaptive speculation: an EMA of the "
                         "draft acceptance rate re-plans draft length and "
                         "draft prune aggressiveness per round (the tokens "
                         "of greedy decode at any plan). Default honors "
                         "REPRO_ADAPTIVE_SPEC, else off")
    ap.add_argument("--no-adaptive-spec", dest="adaptive_spec",
                    action="store_false",
                    help="force adaptive speculation off (fixed draft-len)")
    ap.add_argument("--stream-sched", dest="stream_sched",
                    action="store_true", default=None,
                    help="continuous-batching stream scheduler: token-"
                         "budget admission, prefix-hit-first order, mid-run "
                         "slot recycling, chunked prefill interleaved with "
                         "decode; the static run's tokens. Default honors "
                         "REPRO_STREAM_SCHED, else off")
    ap.add_argument("--no-stream-sched", dest="stream_sched",
                    action="store_false",
                    help="force the stream scheduler off (the static leg)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean request arrivals per engine step (a seeded "
                         "Poisson stream): requests are submitted while "
                         "the engine decodes; 0 submits all up front. "
                         "Needs --stream-sched")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="interleaved-prefill token budget per engine step "
                         "for prompts past the largest bucket; default one "
                         "largest-bucket chunk a step")
    ap.add_argument("--watchdog-steps", type=int, default=500,
                    help="idle engine steps with requests pending before "
                         "the scheduler's watchdog sheds the stalled queue "
                         "head")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault-injection schedule "
                         "('kind@step[:k=v,..];...', kinds exhaust | error "
                         "| nan | slow | kill; see repro_torch.serving."
                         "faults); steps count engine steps (kill: fleet "
                         "steps). Default honors REPRO_FAULT_PLAN, else no "
                         "faults")
    ap.add_argument("--dp", type=int, default=None,
                    help="engine replicas behind one dispatching front-end "
                         "(prefix affinity, then least loaded), sharing "
                         "one set of weights, so the tokens do not depend "
                         "on dispatch. Default honors REPRO_MESH_DP, else 1")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel degree: shard the paged KV pool "
                         "and the decode attention over the KV heads of "
                         "the ranks of a torchrun launch "
                         "(--nproc-per-node >= tp); token-identical to "
                         "tp=1, decoded eagerly. Default honors "
                         "REPRO_MESH_TP, else 1")
    return ap.parse_args(argv)


def init_world(device: str) -> tuple:
    """Join the process group of a ``torchrun`` launch (its RANK,
    WORLD_SIZE and MASTER_ADDR/PORT environment), with a timeout: NCCL
    when every rank has a card of its own, else gloo (NCCL refuses two
    ranks on one card). Returns (rank, the device string of this rank);
    outside a launch of more than one rank, (0, ``device``)."""
    import datetime

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world < 2:
        return 0, device
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import GROUP_TIMEOUT_S
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    nccl = device.startswith("cuda") and torch.cuda.device_count() >= world
    if nccl:
        device = f"cuda:{local}"
    dist.init_process_group(
        "nccl" if nccl else "gloo",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.get_rank(), device


#: the fleet-summed counters of a --dp > 1 summary (the reference's)
FLEET_SUMS = ("tokens_out", "decode_s", "prefill_s", "prefill_calls",
              "prefill_tokens", "decode_steps", "cache_bytes",
              "req_cancelled", "req_deadline", "req_errors",
              "sched_preempted", "watchdog_shed", "faults_injected",
              "queue_rejected")
#: the fleet's own keys copied into a --dp > 1 summary
FLEET_KEYS = ("health", "failovers", "requests_failed_over",
              "replica_queue_depth", "replica_inflight",
              "replica_last_step_s", "fault_plan", "faults_fired",
              "requests_per_replica")


def fleet_summary(fleet) -> dict:
    """Replica 0's summary (shapes, backends) with the throughput and the
    counters summed over the fleet, the HDP stats averaged, and the
    fleet's health, load and fault keys (the reference CLI's merge)."""
    subs = fleet["replicas"]
    s = dict(subs[0])
    for k in FLEET_SUMS:
        s[k] = sum(sub.get(k, 0) for sub in subs)
    if s["decode_s"]:
        s["decode_tok_s"] = s["tokens_out"] / s["decode_s"]
    for k in ("block_sparsity", "head_sparsity", "page_sparsity"):
        s[k] = sum(sub.get(k, 0.0) for sub in subs) / len(subs)
    for k in FLEET_KEYS:
        if k in fleet:
            s[k] = fleet[k]
    s["dp"] = fleet["dp"]
    return s


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    rank, device = init_world(args.device)
    try:
        return serve(args, rank, device)
    finally:
        if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def serve(args: argparse.Namespace, rank: int, device: str) -> int:
    """Serve the seeded traffic of ``args`` on ``device`` and print the
    summary (on rank 0 of a launch)."""
    from repro_torch.attention import AttnSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import (Engine, ReplicaSet, Request,
                                     SchedulerConfig)
    from repro_torch.serving.engine import MESH_DP_ENV

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.no_hdp and cfg.hdp is not None:
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    buckets = (16, 32) if args.reduced else (256, 512, 1024)
    max_len = args.max_len or buckets[-1] + args.max_new
    hi = max_len - args.max_new - args.shared_prefix
    lo = min(buckets[-1] // 4, hi)
    if hi < 1:
        raise SystemExit(f"--max-len {max_len} leaves no room for a prompt "
                         f"(tail) beside --max-new {args.max_new} and "
                         f"--shared-prefix {args.shared_prefix}")
    spec = AttnSpec(backend=args.backend, layout=args.layout,
                    kv_dtype=args.kv_dtype, kv_scale=args.kv_scale,
                    policy=args.policy if args.policy is not None
                    else "auto")
    tuner = None
    if args.tuner_cache:
        from repro_torch.autotune import Tuner
        from repro_torch.roofline.hardware import detect_profile
        tuner = Tuner(detect_profile(args.device),
                      cache_path=args.tuner_cache)
    sched = SchedulerConfig(prefill_chunk_tokens=args.prefill_chunk,
                            watchdog_steps=args.watchdog_steps) \
        if args.stream_sched else None
    engine_kw = dict(device=device, max_batch=args.max_batch,
                     max_len=max_len, prefill_buckets=buckets,
                     collect_stats=True, attn=spec, num_pages=args.num_pages,
                     prefix_cache=args.prefix_cache,
                     decode_horizon=args.decode_horizon,
                     spec_decode=args.spec_decode, draft_len=args.draft_len,
                     adaptive_spec=args.adaptive_spec, tuner=tuner,
                     stream_sched=args.stream_sched, sched=sched,
                     tp=args.tp)
    if args.tp is not None and args.tp > 1:
        # graphs are refused at tp > 1 (an engine that REPRO_MESH_TP
        # shards on the card raises instead of decoding eagerly unasked)
        engine_kw["cuda_graph"] = False
    dp = args.dp if args.dp is not None else \
        int(os.environ.get(MESH_DP_ENV) or 1)
    if dp < 1:
        raise SystemExit(f"--dp must be >= 1, got {dp}")
    if dp > 1:
        eng = ReplicaSet.build(cfg, dp, seed=args.seed,
                               faults=args.fault_plan, **engine_kw)
        eng0 = eng.engines[0]
    else:
        eng = eng0 = Engine(cfg, seed=args.seed, faults=args.fault_plan,
                            **engine_kw)
    if args.arrival_rate > 0 and eng0.sched is None:
        raise SystemExit("--arrival-rate needs --stream-sched")
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(1, cfg.vocab_size, args.shared_prefix).tolist()
    reqs = []
    for uid in range(args.requests):
        n = int(rng.integers(lo, hi + 1))
        reqs.append(Request(uid, shared + rng.integers(
            1, cfg.vocab_size, n).tolist(), max_new_tokens=args.max_new))
    if args.arrival_rate > 0:
        # arrival steps drawn after the prompts: the prompts (and the
        # tokens) stay the static run's
        arrive = poisson_arrivals(rng, args.arrival_rate, args.requests)
        step = 0
        while reqs or eng._n_pending():
            while reqs and arrive[reqs[0].uid] <= step:
                eng.submit(reqs.pop(0))
            eng.step()
            step += 1
        results = eng.results()
    else:
        for req in reqs:
            eng.submit(req)
        results = eng.run()
    summary = fleet_summary(eng.summary()) if dp > 1 else eng.summary()
    summary["completed"] = sum(r.complete for r in results.values())
    # every submitted request must come back as some typed Result, also
    # under injected faults: a lost one is what the fault harness catches
    summary["requests_ok"] = sum(r.status == "ok" for r in results.values())
    summary["requests_failed"] = len(results) - summary["requests_ok"]
    summary["requests_lost"] = args.requests - len(results)
    # order-independent fingerprint of every generated token
    summary["tokens_fp"] = int(np.sum([
        (uid + 1) * (i + 1) * (t + 1) for uid, r in results.items()
        for i, t in enumerate(r.tokens)]) % (2 ** 31))
    if rank != 0:
        # every rank served the same requests; rank 0 reports them
        return 0
    if args.tuner_cache and eng0.tuner is not None:
        eng0.tuner.save(args.tuner_cache)   # warm-start the next run
    print(json.dumps(summary, default=str))
    if summary.get("fault_plan"):
        # under injected faults some requests fail by design: success is
        # that none was lost
        return 0 if summary["requests_lost"] == 0 else 1
    return 0 if summary["completed"] == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
