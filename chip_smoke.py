#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and nvcc, and imports only the port (``src/repro_torch``),
never JAX nor the JAX package. Phases:

1. environment — card name and power limit (nvidia-smi);
2. build — every CUDA source (seven: the FUM decode, the scout's int8
   tensor-core and dp4a kernels, and the tensor-core and tile kernels of
   block-sparse and flash attention), one nvcc each, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the reference tests' small shapes (2x2 blocks and ragged S
   included) and at qwen2-1.5b's full-width shapes: the paged FUM
   decode on int8, fp32, fp8-V (int8 K, fp8 e4m3 V) and bf16 pools (the
   last two also at granite-8b's shape), at Sq 1, 3 and 8 (the verify
   shape; 48 rows split over two row blocks), split across blocks and in
   one pass, each with its poison checks; on the int8 pool also at
   olmoe-1b-7b's decode and verify shapes (MHA: G 1; two blocks a row
   by ``fum_splits``), at G 5 and G 8 (llama4-scout, chameleon-34b) and at
   one rank's shard of qwen2-1.5b at tp 2 (phase 5k: N 1), and
   at olmoe's shape on uniform +-127 codes against the plain version
   evaluated in float64 (the reference's kernel tolerance, 2e-3: fp32
   sum order alone parts kernel and fp32 plain version there);
   the integer scout on both of its paths (theta, keep and theta_head
   bit-equal, ragged S, non-causal, rho < 0, int8 extremes, and the
   bad-input NaN), its tensor-core path also at hd 112 (zamba2-7b's, on
   int8 copies zero-padded to 128 columns: S 4000 and 1000, 64- and
   128-row blocks, strided views, int8 extremes, bad input), each of
   those calls bit-equal to the dp4a kernel too; the block-sparse FUM
   attention on the prefill and the paged-decode routes and flash
   attention (atol = rtol = 1e-4 with fp32 V, 2e-2 with bf16 V) on both
   of their paths, the
   tensor-core path also at S 4000, hd 64 and hd 112 (zamba2-7b's,
   padded to 128 columns in shared memory), non-causal, with a gated head
   and with a q tile that lists no block, and the tile paths at hd 112 in
   fp32 (each call's path asserted);
   scout, block and flash also at olmoe's 16 heads (MHA);
   the no-read poison checks;
4. aligned prefill — qwen2-1.5b at full width (bf16, seeded weights),
   B 2, S 4096, through ``registry.apply_prefill(..., None)``: HDP on
   resolves to ``pallas_hdp_block`` and launches the scout and block
   kernels once per layer, HDP off resolves to ``pallas_flash`` and
   launches flash once per layer, scout, block and flash on the
   tensor-core path; kernel vs plain at the path's own
   inputs; the reduced config's logits on the card equal the CPU's, in
   fp32 and in bf16, its scout on the dp4a path;
5. serving — the same weights serve 8 requests through
   ``Engine.submit``/``run``, first eagerly (``cuda_graph=False``, each
   FUM call recorded and the busiest held against the plain version),
   then on the decode step's CUDA graph at horizons 1 and 4 (the main
   path): identical tokens, the FUM kernel once per layer per decode
   step (pages split across blocks), as the kernel's own count of its
   runs on the card (``.runs``) shows over every serve, graph replays
   included, and the graph faster than the eager steps;
   ``Engine(attn="pallas_hdp_block")`` the block kernel on its tile
   path, eagerly and graphed (counted on the card alike), with
   identical tokens; prompts of 2,500
   and 4,000 tokens through chunked prefill; the reduced config graphed
   on the card, with one prompt chunked, must give the CPU's tokens;
5b. granite-8b at full width cut to 4 of its 36 layers (bf16, seeded
   weights built on the card): 8 requests of up to 4,096 prompt tokens,
   32 new tokens each, on the int8 grid pool, the fp8_v pool and the bf16
   ("fp32") pool through the FUM kernel, the absmax pool through the
   plain stage 3, HDP off on the paged and the dense layout, and HDP on
   on the dense layout (``xla_hdp``); each eagerly and graphed at
   horizon 4 with equal tokens, tok/s, backends, pool format and cache
   bytes per token printed, the FUM kernel's runs counted on the card;
   then the reduced config on each route, card vs CPU;
5c. windowed decode: h2o-danube-1.8b at full width cut to 4 layers,
   its window cut to 512 under prompts of 600-1,000 tokens (decode on
   ``paged_hdp_decode``), eager and graphed equal; the reduced config
   (window 16) card vs CPU;
5d. prefix cache and speculative decode, qwen2-1.5b at full width (run
   right after phase 5, on its weights): a 1,024-token shared prompt
   (a warm-up request, then 6 hits with tails of 32-480 tokens through
   chunked prefill and 2 full hits of its first 512 and 1,024 tokens)
   through the graphed engine at horizon 4 with the prefix cache and
   without, head pruning off: equal tokens, 8 hits, 2 COWs, a drained
   pool, prefill_s hot against cold, then hot on the stock config;
   phase 5's traffic by speculative decode, graphed, at draft lengths 4
   and 8 (one CUDA graph per round width), tokens equal to the graphed
   horizon-1 engine's, the FUM kernel 28 times per verify and never in
   a draft step (the wrappers' counts over each capture, and the
   kernel's count on the card at both draft lengths, read before and
   after each round and so split by the round's width), and the
   kernel against its plain version at the path's verify call that
   listed the most pages, each of its rows bit-equal to the single step
   at that row's position; the bf16 ("fp32") pool with its fraction
   copy cut to 8 layers, spec equal to horizon 1; the reduced config
   with both features, card (graphed) vs CPU;
5e. the moe and vlm model stack: olmoe-1b-7b at full width and depth (16
   layers, 64 experts top-8, qk-norm, 16/16 heads, 13.8 GB of bf16
   weights): its aligned prefill (B 1, S 4096, the MoE's grouped
   branch) through the scout and block kernels and through flash (16
   launches each, tensor-core path, each held against its plain version
   at the path's inputs); 8 requests of 200-2,000 prompt tokens, 32 new,
   on the int8 grid pool, eagerly and graphed at horizons 1 and 4 with
   identical tokens and 16 FUM runs a decode step on the card (split:
   B*N = 128 rows, two blocks a row), the kernel against its plain
   version at the path's busiest call; speculative decode at draft_len 4
   graphed and eager (identical tokens, acceptance printed); the prefix
   traffic hot
   and cold. The MoE drops tokens past an expert's capacity, so spec
   against greedy and hot against cold are printed, not asserted, at
   full width. llama4-scout, chameleon-34b and nemotron-4-15b at full
   width cut to 4 layers, eager and graphed; the four reduced configs
   card vs CPU;
5f. the stream scheduler (ROADMAP item 3a) and the paper's polynomial
   softmax (item 5), qwen2-1.5b at full width on phase 5's weights,
   graphed at horizon 4: 24 requests of 200-1,000 tokens through
   ``Engine(stream_sched=True)`` with tokens equal to the static
   engine's, slots recycled mid-run, the FUM kernel's runs on the card
   equal to the engine's count, TTFT/TPOT/queue wait printed; a
   2,500-token prompt prefilled in 512-token-budget slices while 8 short
   requests decode (interleaved), tokens equal to the static engine's
   blocking chunked prefill; preemption of low-priority requests by two
   high-priority arrivals (head gate off; graphed == eager, the requests
   never preempted equal to the uninterrupted static run, the victims'
   first divergence and top-2 logit margin printed; with HDP off every
   request equal); reduced granite-8b with HDP, horizon 4, prefix cache,
   spec decode and the scheduler, card vs CPU; ``approx_softmax`` on the
   reduced config card vs CPU and one full-width serving prefill with
   and without it;
5g. fault injection, deadlines and replicas (ROADMAP items 3b, 3c),
   qwen2-1.5b at full width on phase 5's weights and traffic, graphed at
   horizon 4: fault-free (tokens equal phase 5's, the decode step now
   reading the NaN mask); ``nan@2:uid=3`` (that request errors, the 7
   others equal phase 5's tokens, one graph capture, the FUM kernel's
   runs on the card = 28 x (decode steps + 1)); ``error@3`` raised out
   of ``run()`` with every static buffer and the pool's addresses as
   the step found them, then a second ``run()`` equal to phase 5's;
   ``exhaust@0`` under the stream scheduler (deferred, equal); a
   deadline expiring while decoding and a queue wait while queued;
   speculative decode at draft_len 4 with a NaN and a step error;
   ``ReplicaSet.build(cfg, 2)`` sharing the weights, equal to the single
   engine, then with ``kill@3:replica=0`` (each uid once, moved requests
   equal up to their failover, their parting printed with its top-2
   margin, asserted a near-tie with HDP off); the reduced config (fp32,
   HDP off) on the reference's chaos plan, card vs CPU. ``[faults]``
   lines, each sub-phase's wall seconds;
5h. the hardware profile, the cost policy and acceptance-adaptive
   speculation (ROADMAP item 7), qwen2-1.5b at full width on phase 5's
   weights and traffic: ``detect_profile()`` is the H100 profile, the
   card's memory its ``mem_bytes``, a 1 GiB device copy and a bf16
   8192^3 matmul at most 1.05 x its peaks, the dispatch constants
   measured beside it (``launch/measure_profile.py``); the cost policy
   graphed at horizon 4 on an explicit tuner that finds every signature
   ambiguous, so each is probed on the card (tokens equal phase 5's,
   decode on the FUM kernel, one probe per pending signature, one
   capture per attention epoch, the FUM kernel's runs on the card = 28
   x (decode steps + warm-ups) + its probe runs), the same traffic on
   the settled decisions, and a warm start from the saved cache (no
   probe, the same decisions and tokens; a CPU cache refused);
   adaptive speculation at draft_len 4, graphed, natural and on the
   reference test's forced plan (tokens equal phase 5's horizon-1
   tokens, each (k, tier) captured once, its FUM runs 28 x (rounds + 1
   warm-up)), beside fixed draft_len 4 and horizon 1. ``[tune]`` lines;
5k. tensor parallelism (ROADMAP item 8): two ranks on the one card in a
   gloo world (NCCL takes one rank per device), each a subprocess of
   this script (``--tp-rank``) that rebuilds phase 5's weights from its
   seed (weight checksum equal to phase 5's) and serves phase 5's
   traffic through ``Engine(tp=2)`` with half the pool's KV heads,
   eagerly at horizons 1 and 4: each rank's tokens equal phase 5's, the
   FUM kernel runs 28 times a decode step on each rank (its own count on
   the card) at one KV head of two, each rank's pool is half of phase
   5's, the head gather goes by broadcasts (gloo on CUDA tensors), and
   ``Engine(tp=2)`` with CUDA graphs raises; each rank's wall seconds,
   tok/s and ``collective_bytes_per_layer`` printed (``[tp]`` lines).
   The ranks are joined with a deadline, their results read from files;
   one that fails, times out or exits non-zero fails the phase;
5i. the recurrent and encoder-decoder families (ROADMAP item 10), each
   at full width and depth with seeded bf16 weights built on the card
   and freed before the next: rwkv6-3b (32 layers, d 2560) and zamba2-7b
   (81 layers: 13 groups of 6 Mamba2 layers and the shared attention
   block, plus 3; HDP on) serve 8 prompts of distinct lengths in 64-512
   (two multiples of 128, zamba2's chunked SSD; six not, its per-step
   scan), 32 new tokens each, batch 8, on the dense layout, eagerly and
   graphed at horizon 4 (identical tokens, one capture, one exact-length
   prefill call per prompt, no decode kernel: rwkv6 decodes on "none",
   zamba2 on ``xla_hdp``), tok/s, ``prefill_s`` and ``graph_capture_s``
   printed; zamba2's aligned prefill (B 1, S 4096, 32 heads at hd 112)
   through the scout and the block kernel (HDP on) and flash (HDP
   off), all on the tensor-core path, 13 launches each, each held
   against its plain version at the path's own inputs, the scout also
   against its dp4a kernel;
   whisper-large-v3 (32 + 32 layers) at model level: 2 x 1500 seeded
   frames, a 16-token prompt, ``registry.apply_prefill`` and 32 greedy
   ``apply_decode`` steps, every logit finite; the reduced rwkv6 and
   zamba2 graphed and reduced whisper's greedy tokens on the card equal
   the CPU's. ``[families]`` lines;
5j. training (ROADMAP item 11a) through ``launch.train.run``, outside
   inference mode, budget ~120 s: (a) qwen2-1.5b at full width and
   depth (28 layers, bf16 weights seeded on the card, remat on), S 4096,
   global batch 8 in 8 microbatches of 1 x 4096, 4 steps of synthetic
   data: every loss and grad norm finite, each step's seconds (first and
   steady), tokens/s, the model FLOP/s (6 N tokens a step) over the bf16
   peak, the peak memory, beside the card's name and power limit; (b)
   the same width cut to 2 layers (S 2048, B 2): 4 steps uninterrupted,
   then 2 steps with a step-2 checkpoint (~4.6 GB: bf16 params, fp32
   master, m, v) whose restore is bit-equal to the saved state, and a
   fresh run resuming from it for 2 more, every loss within rtol 1e-4 of
   the uninterrupted run's; (c) one step each with bf16 gradient
   compression and with 2 microbatches; (d) one train step of the
   reduced qwen2-1.5b, olmoe-1b-7b, rwkv6-3b, zamba2-7b and
   whisper-large-v3 (with frames), fp32 weights made on the CPU, card
   == CPU at the CPU tests' tolerances. No kernel wrapper launches in
   any of them: a trainable attention call declines every kernel (none
   has a gradient), as in the reference. ``[train]`` lines;
5l. sharded training (ROADMAP item 8b), outside inference mode, budget
   ~90 s: two ranks on the one card in a gloo world at (data 2, model
   1), each a subprocess of this script (``--shard-rank``), train
   qwen2-1.5b at full width cut to 8 layers (bf16, remat as configured)
   2 steps at S 4096, global batch 2 (one row a rank), from phase 5j's
   seeds: params held by their specs, m, v and master by ZeRO-1, the
   gradients all-reduced through gloo's CUDA route, the new params
   gathered from the master halves by broadcasts; then this process
   runs the unsharded step on the same batches with 2 microbatches.
   Every loss and grad norm on both ranks, and the gathered params, m,
   v and master, agree with it within the train-step limits of PERF.md
   section 2; each rank's resident state is the size of its shards; no
   kernel launches; the all-reduce bytes each rank sent a step, counted
   as they ran (``sharding.recording``), equal the gradient bytes. Each
   rank's step seconds and peak memory, and the collective bytes it sent
   a step by kind, beside the card's name and power limit. ``[shard]``
   lines;
5m. the dry run beside the card (ROADMAP item 11b), on the host's CPU
   with no card memory, outside inference mode, budget ~90 s:
   ``launch.dryrun`` traces, under ``FakeTensorMode``, phase 5j's cell
   (qwen2-1.5b, S 4096, 8 microbatches of 1 x 4096, one device), phase
   5l's (8 layers at (data 2, model 1), one rank) and qwen2-1.5b
   train_4k on the 16x16 mesh at full width (one rank); each record's
   FLOPs, bytes, collective bytes by kind, argument and peak bytes and
   ``analyze(hw=H100_SXM)``'s three times are printed beside what 5j
   and 5l measured in the same run. Asserted: every record ``ok``; the
   5l cell's traced argument bytes equal the resident bytes 5l measured
   a rank plus the global batch every rank takes; its traced all-reduce
   bytes equal what 5l's ranks sent a step (counted as they ran,
   ``sharding.recording``: 2,431,031,300); traced / measured peak within
   0.5-2.0 for the 5j and 5l cells. ``[dry]`` lines;
5n. the examples (ROADMAP item 12), outside inference mode (they
   train): each script of ``examples_torch/`` run in this process
   through ``runpy`` with its argv, ``common.CACHE_DIR`` a fresh
   temporary directory, so every model is trained on the card.
   quickstart: section 3 launches the scout once on its tensor-core
   path and the block kernel once on its tile path (fp32 V), and
   nothing else launches; both held against their plain versions at the
   recorded inputs (the scout bit-equal), section 3's output against the
   plain pipeline at atol = rtol = 1e-4 and its theta_head and sparsity
   stats equal; "quickstart OK". train_lm: 20 steps into a temporary
   checkpoint directory, exit 0, no kernel launched. pruning_sweep:
   bench-tiny trained 300 steps (its first and last loss printed, the
   loss falls), the eight-row table; its densest and sparsest rows
   recomputed on the CPU: on the card's own Q/K/V the keep masks and
   head gates equal and net sparsity within 1e-6; from the card's
   weights (a CPU forward) agreement equal, and a keep mask differs
   only where the CPU's Q or K rounds to another integer part (counted
   and printed), each differing token printed with its top-2 margin;
   the printed row equal to the recomputed one. serve_hdp at bench-tiny
   (the sweep's cached model) and bench-base (trained 300 steps): the
   HDP serve decodes on the FUM route at page size 2 (hd 64 and hd 32,
   MHA), the kernel's runs on the card = layers x (decode steps + 1
   warm-up), both serves' tokens equal the same serves on the CPU from
   the card's weights; each summary printed beside the card's name and
   power limit. ``[examples]`` lines;
6. timing — each kernel and its plain version at the main path's shape
   (CUDA events around device work only, L2 flushed between launches)
   beside its bound and, where one PyTorch call computes the same
   function, that call; the tile paths at the calls that take them (the
   decode route's block call; flash in fp32 at the prefill's shape); the
   scout's dp4a kernel and the FUM decode in one pass (the earlier
   designs) at the same inputs as their successors; the FUM decode at
   the verify shape (Sq 4 and 8, the timing case's widths); its fp8-V
   and bf16 pool variants at the int8 timing case's values; the FUM
   decode at olmoe-1b-7b's decode shape (at the rule's S and in one
   pass) and at phase 5k's shard (N 1); the scout, block and flash
   kernels (tensor core) at zamba2-7b's aligned prefill (hd 112), the
   scout beside its dp4a kernel and flash beside bf16
   ``scaled_dot_product_attention``.

Each phase's wall seconds are printed as it ends and together before
the kernels line.

Prints the per-kernel JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that last line.
"""
from __future__ import annotations

import json
import logging
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: NVIDIA H100 SXM data-sheet peaks (dense, at the full 700 W limit). The
#: HBM3 rate and the bf16 peak are the H100 hardware profile's
#: (``repro_torch.roofline.hardware.H100_SXM``, the cost model's
#: yardstick), set in main() once the port is importable
HBM_BYTES_S = BF16_FLOP_S = None
FP32_FLOP_S = 67e12
INT8_OPS_S = 1979e12
ATOL = RTOL = 1e-4   # fp32 accumulation in both; only the sum order differs
TOL_BF16 = 2e-2      # p is rounded to bf16 before P.V in both
#: the reference's kernel tolerance (tests/test_kernels.py), for a kernel
#: against the plain version evaluated in float64
TOL_KERNEL_F64 = 2e-3
THETA_RTOL = 1e-5
N_LAYERS_QWEN = 28
SOURCES = ("hdp_paged_decode", "hdp_scout", "hdp_scout_tc", "hdp_block_attn",
           "hdp_block_attn_tc", "flash_attention", "flash_attention_tc")
PREFILL_B, PREFILL_S = 2, 4096
#: olmoe-1b-7b's aligned prefill in phase 5e: MHA, 16 heads, B 1
MHA_PREFILL = (1, 16, PREFILL_S, 128)
#: why a kernel has no library_ms: no single PyTorch call computes it
NO_LIBRARY_CALL = {
    "hdp_paged_fum_decode": "no PyTorch call attends over a paged pool's "
                            "listed pages with the FUM scores",
    "hdp_scout": "no PyTorch call pools |IQ.IK^T| per block and applies "
                 "the row threshold",
    "hdp_block_sparse_attention": "no PyTorch call attends over listed "
                                  "blocks with the FUM scores QK^T - FQ.FK^T",
}


#: worst max |kernel - plain| of each kernel entry of the scout, block and
#: flash wrappers, filled by check_scout, check_block and check_flash
#: (entry: the wrapper's name, "[<path>]" added off the tensor-core path)
ERRS = {}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg=""):
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1
def phase_env(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(smi_line)
    return name, smi_line


# ------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(SOURCES)
    log(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, rec in built.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


# ------------------------------------------------------------ phase 3
#: FUM pool formats: int8 codes, int8 K + fp8 V pages (scale 1.0), and
#: unquantized pools in fp32 and in bf16 (the model dtype at full width)
FUM_FORMATS = ("int8", "fp32", "fp8_v", "bf16")
#: the tolerance of each format against the plain version: p is rounded
#: to bf16 before p.V on a bf16 pool, relative to each block's running
#: max when the pages are split, so the roundings differ there
FUM_TOL = {"int8": ATOL, "fp32": ATOL, "fp8_v": ATOL, "bf16": TOL_BF16}
#: the FUM kernel's case at olmoe-1b-7b's decode shape (MHA: G 1), with
#: the unit-RMS queries and keys of its qk-norm. On the uniform +-127
#: codes the scores reach ~60, and fp32 sum order alone moves outputs by
#: up to 3e-4: the kernel and the plain version each differ that much
#: from the plain version in float64 at every shape of this phase (the
#: "fp32 sum order" lines), and agree with each other only while both
#: sum in one order; at G*Sq = 1 cuBLAS sums the plain version's scores
#: in another. That case is held against the plain version evaluated in
#: float64 instead, at the reference's kernel tolerance (TOL_KERNEL_F64)
OLMOE_FUM = dict(B=8, N=16, G=1, hd=128, ps=128, nP=16, fmt="int8", live=0.5,
                 unit=True)
OLMOE_FUM_LABEL = "olmoe B8N16G1"
#: the FUM kernel's case at one rank's shard of qwen2-1.5b's decode at
#: tp 2 (phase 5k): one of the two KV heads
TP_FUM = dict(B=8, N=1, G=6, Sq=1, hd=128, ps=128, nP=16, fmt="int8",
              live=0.5)
TP_FUM_LABEL = "qwen2 tp2 shard B8N1G6Sq1hd128ps128 int8"


def make_case(torch, *, B, N, G, Sq, hd, ps, nP, fmt, live, seed,
              unit=False):
    """Paged FUM decode inputs the way the serving path builds them: a
    pool in format ``fmt`` whose rows own distinct pages, a keep mask,
    and the fetch list compressed by the model's own ``_fetch_list``.
    Queries 2 x N(0, 1) on the Q4.12 grid and int8 codes uniform over
    +-127, or with ``unit`` (int8 pools) the values a qk-norm model
    stores: unit-RMS queries, K and V encoded onto the pool grid."""
    from repro_torch.core.quant import (encode_pool, pool_scale,
                                        quantize_fixed, to_fp8_e4m3)
    from repro_torch.models.attention import _fetch_list
    g = torch.Generator().manual_seed(seed)
    P = 1 + B * nP
    Sk = nP * ps
    qq = quantize_fixed((1.0 if unit else 2.0)
                        * torch.randn(B, N, G, Sq, hd, generator=g))
    if unit:
        kp, vp = (encode_pool(torch.randn(P, ps, N, hd, generator=g))
                  for _ in range(2))
        ks = vs = torch.full((P, N), pool_scale(4))
    elif fmt in ("int8", "fp8_v"):
        kp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        ks = torch.full((P, N), pool_scale(4))
        vs = torch.full((P, N), pool_scale(4))
        if fmt == "fp8_v":
            vp = to_fp8_e4m3(4.0 * torch.randn(P, ps, N, hd, generator=g))
            vs = torch.ones((P, N))
    else:
        dt = torch.bfloat16 if fmt == "bf16" else torch.float32
        kp = (4.0 * torch.randn(P, ps, N, hd, generator=g)).to(dt)
        vp = torch.randn(P, ps, N, hd, generator=g).to(dt)
        ks = vs = None
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, nP)
    page_live = torch.rand(B, nP, generator=g) < live
    keep = (torch.rand(B, N, G, nP, generator=g) < 0.6) \
        & page_live[:, None, None, :]
    fetched = keep.any(dim=2).any(dim=1)
    q0 = torch.randint(Sk // 2, Sk - Sq + 1, (B,), generator=g)
    q_pos = (q0[:, None] + torch.arange(Sq))[:, None, None, :]
    page_ids, logical, counts, keep_in, kv_len = _fetch_list(
        fetched, table, keep, q_pos)
    return dict(qq=qq, k_pool=kp, v_pool=vp, page_ids=page_ids,
                logical=logical, counts=counts, keep=keep_in, kv_len=kv_len,
                k_scale=ks, v_scale=vs, table=table, fetched=fetched,
                fmt=fmt)


def to_dev(case, dev):
    return {k: (v.to(dev) if hasattr(v, "to") else v)
            for k, v in case.items()}


def kernel_args(c):
    return ((c["qq"], c["k_pool"], c["v_pool"], c["page_ids"], c["logical"],
             c["counts"], c["keep"], c["kv_len"]),
            dict(k_scale=c["k_scale"], v_scale=c["v_scale"]))


def poison_pages(torch, c, pages, *, stage3_only):
    """Copies of the case's pools and scales with ``pages`` poisoned: V
    codes (int8 -128, fp8 NaN) and both scales of a quantized pool, with
    ``stage3_only`` (the pruned pages: K codes are the scout's stream and
    stay) or its K scale (a fetched page); NaN K and V of an unquantized
    pool."""
    from repro_torch.core.quant import POISON_CODE
    kp, vp = c["k_pool"].clone(), c["v_pool"].clone()
    ks = None if c["k_scale"] is None else c["k_scale"].clone()
    vs = None if c["v_scale"] is None else c["v_scale"].clone()
    if ks is None:
        kp[pages] = float("nan")
        vp[pages] = float("nan")
    elif stage3_only:
        if vp.dtype == torch.int8:
            vp[pages] = POISON_CODE
        else:
            vp[pages] = float("nan")
        ks[pages] = float("nan")
        vs[pages] = float("nan")
    elif vp.dtype == torch.int8:
        ks[pages] = float("nan")
    else:
        vp[pages] = float("nan")       # a NaN fp8 V code
    return kp, vp, ks, vs


def phase_kernels(torch):
    """The FUM decode kernel on every pool format (int8, fp32, fp8 V,
    bf16), split across blocks (``fum_splits``' S, and S = 3) and in one
    pass (S = 1), against its plain version on every case, with the two
    poison checks in each mode; on the int8 pool also at the moe and vlm
    configs' head groups. Returns (worst max |err| per mode on the int8
    and fp32 pools, per format of the split mode and on olmoe's cases;
    the qwen2 int8 case; olmoe's Sq-1 case)."""
    from repro_torch.kernels.hdp_paged_decode import (fum_splits,
                                                      hdp_paged_fum_decode)
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    cases, tp_case = [], None
    for fmt in FUM_FORMATS:
        for Sq in (1, 3):
            cases.append((f"test B2N2G2Sq{Sq}hd8ps4 {fmt}",
                          dict(B=2, N=2, G=2, Sq=Sq, hd=8, ps=4, nP=8,
                               fmt=fmt, live=0.5, seed=Sq)))
        for Sq in (1, 3, 8):
            cases.append((f"qwen2 B8N2G6Sq{Sq}hd128ps128 {fmt}",
                          dict(B=8, N=2, G=6, Sq=Sq, hd=128, ps=128, nP=16,
                               fmt=fmt, live=0.5,
                               seed=7 if Sq == 1 else 8)))
        if fmt in ("fp8_v", "bf16"):
            cases.append((f"granite B8N8G4Sq1hd128ps128 {fmt}",
                          dict(B=8, N=8, G=4, Sq=1, hd=128, ps=128, nP=33,
                               fmt=fmt, live=0.3, seed=9)))
    # the moe and vlm configs' decode and verify shapes on the int8 pool:
    # olmoe is MHA (G 1; B*N = 128 rows, so fum_splits gives two blocks a
    # row), llama4-scout G 5, chameleon G 8
    for Sq in (1, 4):
        cases.append((f"{OLMOE_FUM_LABEL}Sq{Sq}hd128ps128 int8",
                      dict(OLMOE_FUM, Sq=Sq, seed=30 + Sq)))
    for name, G in (("llama4-scout", 5), ("chameleon", 8)):
        cases.append((f"{name} B8N8G{G}Sq1hd128ps128 int8",
                      dict(B=8, N=8, G=G, Sq=1, hd=128, ps=128, nP=16,
                           fmt="int8", live=0.5, seed=40 + G)))
    # one rank's shard of qwen2-1.5b's decode at tp 2 (phase 5k): N 1
    cases.append((TP_FUM_LABEL, dict(TP_FUM, seed=50)))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, main_case, olmoe_case = {"split": 0.0, "single": 0.0}, None, None
    worst.update({f: 0.0 for f in FUM_FORMATS})
    for label, kw in cases:
        c = to_dev(make_case(torch, **kw), "cuda")
        args, kws = kernel_args(c)
        ref = hdp_paged_fum_decode_ref(*args, **kws)
        tol = FUM_TOL[kw["fmt"]]
        if kw["fmt"] == "int8" and kw["hd"] == 128:
            fp32_sum_order(torch, label, args, kws, ref)
        auto = fum_splits(kw["B"], kw["N"], c["page_ids"].shape[1], n_sm,
                          kw["G"])
        for mode, splits in (("split" if auto > 1 else "single", None),
                             ("split", 3), ("single", 1)):
            tag = f"{label} [{mode}, S={splits or f'fum_splits={auto}'}]"
            fmt0 = hdp_paged_fum_decode.launches_by_format[kw["fmt"]]
            out, ran = on_path(tag, hdp_paged_fum_decode,
                               lambda: hdp_paged_fum_decode(
                                   *args, **kws, splits=splits), mode)
            torch.cuda.synchronize()
            check(hdp_paged_fum_decode.launches_by_format[kw["fmt"]]
                  == fmt0 + 1, f"{tag}: not launched as the {kw['fmt']} "
                  f"format ({hdp_paged_fum_decode.launches_by_format})")
            check(bool(torch.isfinite(out).all()), f"{tag}: non-finite output")
            err = (out - ref).abs().max().item()
            check(torch.allclose(out, ref, atol=tol, rtol=tol),
                  f"{tag}: kernel vs plain max |err| {err:.3e} (tol {tol})")
            # pruned pages are never read: poisoning them (V codes and
            # both scales, or NaN K/V) leaves the output bit-identical
            pruned = c["table"][~c["fetched"]].long()
            check(pruned.numel() > 0, f"{tag}: no pruned pages")
            kp, vp, ks, vs = poison_pages(torch, c, pruned, stage3_only=True)
            out_bad = hdp_paged_fum_decode(
                c["qq"], kp, vp, *args[3:], k_scale=ks, v_scale=vs,
                splits=splits)
            check(torch.equal(out, out_bad),
                  f"{tag}: poison on pruned pages changed the output")
            # ... and poison on one fetched, visible page must surface as
            # NaN (a NaN K scale, NaN fp8 V codes, or NaN K values)
            ps = kw["ps"]
            mk = c["page_ids"].shape[1]
            seen = (torch.arange(mk, device=c["counts"].device)[None]
                    < c["counts"][:, None]) \
                & (c["logical"] * ps < c["kv_len"][:, None])
            b, j = (int(x) for x in torch.nonzero(seen)[0])
            vis = int(c["page_ids"][b, j])
            kp, vp, ks, vs = poison_pages(torch, c, vis, stage3_only=False)
            out_nan = hdp_paged_fum_decode(
                c["qq"], kp, vp, *args[3:], k_scale=ks, v_scale=vs,
                splits=splits)
            torch.cuda.synchronize()
            check(bool(torch.isnan(out_nan[b]).any()),
                  f"{tag}: poison on a fetched page did not surface")
            log(f"[kernels] {tag}: max |kernel - plain| {err:.3e}, "
                f"pages kept {int(c['counts'].sum())}/{c['table'].numel()}, "
                "poison checks ok")
            if label == TP_FUM_LABEL:
                # its own kernels-line entry
                worst["tp2"] = max(worst.get("tp2", 0.0), err)
                continue
            if kw["fmt"] in ("int8", "fp32"):
                worst[mode] = max(worst[mode], err)
            if mode == "split":
                worst[kw["fmt"]] = max(worst[kw["fmt"]], err)
            if label.startswith(OLMOE_FUM_LABEL):
                worst["olmoe"] = max(worst.get("olmoe", 0.0), err)
        if label.startswith("qwen2 B8N2G6Sq1") and kw["fmt"] == "int8":
            main_case = c
        if label.startswith(f"{OLMOE_FUM_LABEL}Sq1"):
            olmoe_case = c
        if label == TP_FUM_LABEL:
            tp_case = c
    # olmoe's shape with the uniform codes above: kernel and plain fp32
    # version part by fp32 sum order alone (see OLMOE_FUM), so the kernel
    # is held against the plain version evaluated in float64, in every
    # mode, at the reference's kernel tolerance
    c = to_dev(make_case(torch, **dict(OLMOE_FUM, Sq=1, seed=31,
                                       unit=False)), "cuda")
    args, kws = kernel_args(c)
    label = f"{OLMOE_FUM_LABEL}Sq1 with uniform +-127 codes"
    exact = fp32_sum_order(torch, label, args, kws,
                           hdp_paged_fum_decode_ref(*args, **kws))
    auto = fum_splits(OLMOE_FUM["B"], OLMOE_FUM["N"], c["page_ids"].shape[1],
                      n_sm, OLMOE_FUM["G"])
    for mode, splits in (("split" if auto > 1 else "single", None),
                         ("split", 3), ("single", 1)):
        out = hdp_paged_fum_decode(*args, **kws, splits=splits).double()
        torch.cuda.synchronize()
        err = (out - exact).abs().max().item()
        check(bool(torch.isfinite(out).all()) and torch.allclose(
            out, exact, atol=TOL_KERNEL_F64, rtol=TOL_KERNEL_F64),
            f"{label} [{mode}, S={splits or auto}]: kernel vs plain in "
            f"float64 max |err| {err:.3e} (tol {TOL_KERNEL_F64})")
        log(f"[kernels] {label} [{mode}, S={splits or auto}]: max |kernel - "
            f"plain in float64| {err:.3e} (tol {TOL_KERNEL_F64})")
        worst["olmoe_f64"] = max(worst.get("olmoe_f64", 0.0), err)
    return worst, main_case, olmoe_case, tp_case


def fp32_sum_order(torch, label, args, kws, ref):
    """Logs how far fp32 sum order moves the FUM outputs of a case: the
    kernel's and the plain version's max |distance| from the plain
    version evaluated in float64, and from each other. Returns the plain
    version's output in float64."""
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    exact = hdp_paged_fum_decode_ref(args[0].double(), *args[1:], **kws,
                                     dtype=torch.float64)
    out = hdp_paged_fum_decode(*args, **kws)
    torch.cuda.synchronize()
    dist = lambda a, b: (a.double() - b.double()).abs().max().item()
    log(f"[kernels] {label}: fp32 sum order: max |kernel - plain in "
        f"float64| {dist(out, exact):.3e}, |plain - plain in float64| "
        f"{dist(ref, exact):.3e}, |kernel - plain| {dist(out, ref):.3e} "
        f"(max |output| {exact.abs().max().item():.3e})")
    return exact


# ----------------------------------------------- phase 3: the new kernels
def _randn(torch, shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).cuda()


def fixed_grid_split(torch, x):
    """(qq, iq) of x the way hdp_attention_tpu makes them ("max"
    calibration onto the Q4.12 grid): integer parts in [-16, 15]."""
    from repro_torch.core.quant import calib_scale, quantize_fixed
    xq = quantize_fixed(x.float() * calib_scale(x, 4, "max"))
    return xq, torch.trunc(xq)


def same_bits(torch, a, b):
    """Equal tensors, NaN where the other is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_scout(torch, label, iq, ik, path=None, force=None, twin=False,
                **kw):
    """Scout kernel vs plain: theta, keep and theta_head bit-equal (every
    sum is an exact integer rounded once, in both). ``path``: the path
    the call must take; ``force``: the wrapper's ``path`` argument; with
    ``twin`` the dp4a kernel on the same inputs, bit-equal to the call's
    kernel too."""
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import hdp_scout_plain
    (th, kp, hh), ran = on_path(label, hdp_scout, lambda: hdp_scout(
        iq, ik, path=force, **kw), path)
    pth, pkp, phh = hdp_scout_plain(iq, ik, **kw)
    if twin:
        got = on_path(f"{label} [dp4a twin]", hdp_scout, lambda: hdp_scout(
            iq, ik, path="dp4a", **kw), "dp4a")[0]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((th, kp, hh), got)),
              f"{label}: the {ran} and dp4a kernels' theta, keep or "
              "theta_head differ")
        note_err("hdp_scout", "dp4a", (got[0] - pth).abs().max().item())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(th).all() and torch.isfinite(hh).all()),
          f"{label}: non-finite theta")
    err = (th - pth).abs().max().item()
    check(torch.equal(th, pth),
          f"{label} [{ran}]: theta kernel vs plain max |err| {err:.3e}")
    check(torch.equal(hh, phh),
          f"{label} [{ran}]: theta_head kernel vs plain differ")
    check(torch.equal(kp, pkp), f"{label} [{ran}]: keep differs in "
          f"{int((kp != pkp).sum())} blocks")
    log(f"[kernels] {label} [{ran}]: theta, keep and theta_head bit-equal "
        f"to the plain version" + (" and to the dp4a kernel's" if twin
                                   else ""))
    note_err("hdp_scout", ran, err)
    return err


def check_scout_bad_input(torch, path, hd=None):
    """A value that is not an integer in [-128, 127] (0.5 in a q row of
    head 0, 200 in a k row of head 1) turns the theta of exactly the q
    tiles that read it to NaN, their keep to 0 and the heads' theta_head
    to NaN; every other tile equals the plain version. Blocks of 128
    at hd 128 (or ``hd``) on the tensor-core path, of 32 at hd 16 (or
    128 at ``hd``) on the dp4a path. Returns (theta, keep, theta_head)."""
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import hdp_scout_plain
    bq = 128 if path == "tensor_core" or hd else 32
    hd = hd or (128 if path == "tensor_core" else 16)
    shape = (1, 2, 4 * bq, hd)
    _, iq = fixed_grid_split(torch, _randn(torch, shape, 9))
    _, ik = fixed_grid_split(torch, _randn(torch, shape, 10))
    iq[0, 0, bq + 2, 5] = 0.5          # q tile 1 of head 0
    ik[0, 1, 2 * bq + 4, 7] = 200.0    # k block 2 of head 1: tiles 2, 3
    kw = dict(rho_b=0.5, block_q=bq, block_k=bq, causal=True)
    tag = f"hdp_scout bad input hd {hd} [{path}]"
    (th, kp, hh), _ = on_path(tag, hdp_scout, lambda: hdp_scout(
        iq, ik, path=path, **kw), path)
    pth, pkp, _ = hdp_scout_plain(iq, ik, **kw)
    torch.cuda.synchronize()
    want = torch.tensor([[[False, True, False, False],
                          [False, False, True, True]]], device="cuda")
    nan_tile = torch.isnan(th).all(-1)
    check(torch.equal(nan_tile, want)
          and not bool(torch.isnan(th[~want]).any()),
          f"{tag}: NaN tiles {nan_tile.tolist()}, "
          f"expected {want.tolist()}")
    check(not bool(kp[want].any()) and torch.equal(kp[~want], pkp[~want])
          and torch.equal(th[~want], pth[~want]),
          f"{tag}: keep or clean tiles differ")
    check(bool(torch.isnan(hh).all()),
          f"{tag}: theta_head {hh.tolist()}")
    log(f"[kernels] {tag}: the 3 tiles that read it NaN with no kept "
        "block, both heads' theta_head NaN, the rest bit-equal")
    return th, kp, hh


def block_case(torch, *, B, H, S, hd, bq, bk, v_bf16, seed, gate=True,
               causal=True):
    """Block-kernel inputs as the pipeline makes them: fixed-grid qq/kq,
    the scout's keep on the card, its lists, one head gated."""
    from repro_torch.kernels.ref import hdp_scout_plain, keep_mask_to_indices
    qq, iq = fixed_grid_split(torch, _randn(torch, (B, H, S, hd), seed))
    kq, ik = fixed_grid_split(torch, _randn(torch, (B, H, S, hd), seed + 1))
    v = _randn(torch, (B, H, S, hd), seed + 2)
    if v_bf16:
        v = v.to(torch.bfloat16)
    theta, keep, _ = hdp_scout_plain(iq, ik, rho_b=0.5, block_q=bq,
                                     block_k=bk, causal=causal)
    idx, cnt = keep_mask_to_indices(keep, theta, keep.shape[-1])
    hk = torch.ones(B, H, dtype=torch.bool, device="cuda")
    if gate:
        hk[0, -1] = False
    return dict(q=qq, k=kq, v=v, kv_idx=idx, counts=cnt, head_kept=hk,
                causal=causal, block_q=bq, block_k=bk, score_scale=None,
                kv_len=None)


def decode_route_case(torch, seed):
    """The paged decode's block-kernel call at qwen2-1.5b's shape: one
    query row per (b, h) in an 8-row tile, 9 pages of 128 densified, a
    page keep mask, per-row kv_len, non-causal."""
    from repro_torch.core.quant import quantize_fixed
    from repro_torch.kernels.ref import keep_mask_to_indices
    B, H, hd, ps, nP = 8, 12, 128, 128, 9
    qq = quantize_fixed(_randn(torch, (B, H, 1, hd), seed, 2.0))
    kq = quantize_fixed(_randn(torch, (B, H, nP * ps, hd), seed + 1, 2.0))
    v = _randn(torch, (B, H, nP * ps, hd), seed + 2)
    g = torch.Generator().manual_seed(seed)
    keep = (torch.rand(B, H, 1, nP, generator=g) < 0.5).cuda()
    keep[..., 0] = True
    theta = torch.rand(B, H, 1, nP, generator=g).cuda()
    idx, cnt = keep_mask_to_indices(keep, theta, nP)
    lens = torch.randint(nP * ps // 2, nP * ps + 1, (B, 1), generator=g)
    hk = torch.rand(B, H, generator=g) < 0.8
    return dict(q=qq, k=kq, v=v, kv_idx=idx, counts=cnt,
                head_kept=hk.cuda(), causal=False, block_q=8, block_k=ps,
                score_scale=1.0, kv_len=lens.expand(B, H).int().cuda())


def block_args(c):
    return ((c["q"], c["k"], c["v"], c["kv_idx"], c["counts"],
             c["head_kept"]),
            {"approx": c.get("approx", True),
             **{k: c[k] for k in ("causal", "block_q", "block_k",
                                  "score_scale", "kv_len")}})


def on_path(label, fn, call, path):
    """Runs call() through the wrapper fn; checks that it launched one
    kernel, on ``path`` when one is given. Returns (result, path)."""
    before = dict(fn.launches_by_path)
    out = call()
    ran = [p for p, n in fn.launches_by_path.items() if n != before[p]]
    check(len(ran) == 1 and path in (None, ran[0]),
          f"{label}: launched on {ran}, expected {path or 'one path'}")
    return out, ran[0]


def check_block(torch, label, c, poison=True, path=None):
    """Block kernel vs plain; with ``poison`` NaN in every K/V block no
    q tile lists (and all of a gated head's) leaves the output
    bit-identical. Returns max |err|."""
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.ref import hdp_block_sparse_attention_plain
    args, kw = block_args(c)
    out, ran = on_path(label, hdp_block_sparse_attention,
                       lambda: hdp_block_sparse_attention(*args, **kw), path)
    ref = hdp_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = TOL_BF16 if c["v"].dtype == torch.bfloat16 else ATOL
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, atol=tol, rtol=tol),
          f"{label}: kernel vs plain max |err| {err:.3e}")
    n_unlisted = 0
    if poison:
        B, H, Sk, hd = c["k"].shape
        bk = c["block_k"]
        nk = -(-Sk // bk)
        mk = c["kv_idx"].shape[-1]
        listed = torch.zeros(B, H, nk + 1, dtype=torch.bool, device="cuda")
        live = (torch.arange(mk, device="cuda") < c["counts"][..., None]) \
            & c["head_kept"][..., None, None]
        blk = torch.where(live, c["kv_idx"].long(), nk)
        listed.scatter_(2, blk.flatten(2), True)
        col_listed = listed[..., :nk].repeat_interleave(bk, -1)[..., :Sk]
        n_unlisted = int((~listed[..., :nk]).sum())
        check(n_unlisted > 0, f"{label}: every block is listed")
        kp = torch.where(col_listed[..., None], c["k"], float("nan"))
        vp = torch.where(col_listed[..., None], c["v"],
                         torch.tensor(float("nan"), dtype=c["v"].dtype,
                                      device="cuda"))
        out_bad = hdp_block_sparse_attention(args[0], kp, vp, *args[3:], **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, out_bad),
              f"{label}: NaN in unlisted K/V blocks changed the output")
    log(f"[kernels] {label} [{ran}]: max |kernel - plain| {err:.3e}"
        + (f", {n_unlisted} unlisted blocks poisoned: output bit-identical"
           if poison else ""))
    note_err("hdp_block_sparse_attention", ran, err)
    return err


def check_flash(torch, label, q, k, v, causal, bq, bk, path=None):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    out, ran = on_path(label, flash_attention, lambda: flash_attention(
        q, k, v, causal=causal, block_q=bq, block_k=bk), path)
    ref = flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
    torch.cuda.synchronize()
    tol = TOL_BF16 if q.dtype == torch.bfloat16 else ATOL
    check(out.dtype == q.dtype and bool(torch.isfinite(out).all()),
          f"{label}: wrong dtype or non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
          f"{label}: kernel vs plain max |err| {err:.3e}")
    log(f"[kernels] {label} [{ran}]: max |kernel - plain| {err:.3e}")
    note_err("flash_attention", ran, err)
    return err


def note_err(name, path, err):
    entry = name if path == "tensor_core" else f"{name}[{path}]"
    ERRS[entry] = max(ERRS.get(entry, 0.0), err)


def scout_hd112(torch):
    """The scout at zamba2-7b's hd 112 on the tensor-core path (int8
    copies zero-padded to 128 columns), each call held bit-equal to the
    plain version and to the dp4a kernel: S 4000 and 1000 (ragged),
    causal and full, 128x128, 64x128, 128x64 and 64x64 blocks, rho of
    both signs, the prefill's strided [B, H, S, hd] views of [B, S, H,
    hd] tensors, int8 extremes, and the bad-input NaN."""
    for shape, (bq, bk), rho, causal in (
            ((1, 3, 4000, 112), (128, 128), 0.5, True),
            ((1, 3, 4000, 112), (128, 128), -0.5, False),
            ((1, 2, 1000, 112), (64, 128), 0.5, True),
            ((1, 2, 1000, 112), (128, 64), -0.5, False),
            ((1, 2, 1000, 112), (64, 64), 0.5, False)):
        _, iq = fixed_grid_split(torch, _randn(torch, shape, 27))
        _, ik = fixed_grid_split(torch, _randn(torch, shape, 28))
        check_scout(torch, f"hdp_scout {shape} blocks {bq}x{bk} rho {rho} "
                    f"{'causal' if causal else 'full'}", iq, ik,
                    path="tensor_core", twin=True, rho_b=rho, block_q=bq,
                    block_k=bk, causal=causal)
    _, iq = fixed_grid_split(torch, _randn(torch, (1, 1000, 3, 112), 27))
    _, ik = fixed_grid_split(torch, _randn(torch, (1, 1000, 3, 112), 28))
    for causal in (True, False):
        check_scout(torch, "hdp_scout (1, 3, 1000, 112) strided views blocks "
                    f"128x128 {'causal' if causal else 'full'}",
                    iq.transpose(1, 2), ik.transpose(1, 2),
                    path="tensor_core", twin=True, rho_b=0.5, block_q=128,
                    block_k=128, causal=causal)
    g = torch.Generator().manual_seed(29)
    for shape in ((1, 2, 384, 112), (1, 1, 300, 112)):
        iq, ik = (torch.where(torch.rand(shape, generator=g) < 0.5, -128.0,
                              127.0).cuda() for _ in range(2))
        ik[..., ::3, :] = -128.0
        for causal in (True, False):
            check_scout(torch, f"hdp_scout {shape} int8 extremes "
                        f"{'causal' if causal else 'full'}", iq, ik,
                        path="tensor_core", twin=True, rho_b=0.5,
                        block_q=128, block_k=128, causal=causal)
    tc, dp = (check_scout_bad_input(torch, path, hd=112)
              for path in ("tensor_core", "dp4a"))
    check(all(same_bits(torch, a, b) for a, b in zip(tc, dp)),
          "hdp_scout bad input hd 112: the tensor-core and dp4a kernels' "
          "theta, keep or theta_head differ")
    log("[kernels] hdp_scout bad input hd 112: tensor-core == dp4a, NaNs "
        "included")


def phase_new_kernels(torch):
    """Scout, block and flash kernels vs their plain versions (their
    errors go to ERRS)."""
    small = [((1, 2, 128, 64), (64, 64)), ((1, 2, 18, 8), (2, 2)),
             ((1, 1, 100, 16), (32, 16))]
    # the scout: the reference tests' shapes (64x64 blocks at hd 64 take
    # the tensor-core path, 2x2 and 32x16 the dp4a path), the prefill's,
    # and the tensor-core path's edges: ragged S, 64-row blocks, hd 32 and
    # 96, int8 extremes (|s| up to 2^21, block sums up to 2^35)
    scout_cases = [(shape, blocks, rho, causal)
                   for shape, blocks in small for rho in (0.5, -0.5)
                   for causal in (True, False)]
    scout_cases += [((PREFILL_B, 12, PREFILL_S, 128), (128, 128), rho, True)
                    for rho in (0.5, -0.5)]
    scout_cases += [(MHA_PREFILL, (128, 128), 0.5, True)]
    scout_cases += [((1, 3, 300, 128), (128, 128), rho, causal)
                    for rho in (0.5, -0.5) for causal in (True, False)]
    scout_cases += [((1, 2, 384, 128), (64, 128), -0.5, True),
                    ((1, 2, 384, 128), (128, 64), 0.5, False),
                    ((1, 2, 250, 96), (64, 64), 0.5, True),
                    ((1, 2, 250, 32), (128, 128), -0.5, False)]
    from repro_torch.kernels.hdp_scout import scout_path
    for shape, (bq, bk), rho, causal in scout_cases:
        _, iq = fixed_grid_split(torch, _randn(torch, shape, 7))
        _, ik = fixed_grid_split(torch, _randn(torch, shape, 8))
        label = (f"hdp_scout {shape} blocks {bq}x{bk} rho {rho} "
                 f"{'causal' if causal else 'full'}")
        check_scout(torch, label, iq, ik, path=scout_path(shape[3], bq, bk),
                    rho_b=rho, block_q=bq, block_k=bk, causal=causal)
    # [B, H, S, hd] views of [B, S, H, hd] tensors, as the prefill passes
    _, iq = fixed_grid_split(torch, _randn(torch, (1, 300, 3, 128), 7))
    _, ik = fixed_grid_split(torch, _randn(torch, (1, 300, 3, 128), 8))
    check_scout(torch, "hdp_scout (1, 3, 300, 128) strided views blocks "
                "128x128", iq.transpose(1, 2), ik.transpose(1, 2),
                path="tensor_core", rho_b=0.5, block_q=128, block_k=128,
                causal=True)
    g = torch.Generator().manual_seed(3)
    for shape in ((1, 2, 384, 128), (1, 1, 300, 128)):
        iq, ik = (torch.where(torch.rand(shape, generator=g) < 0.5, -128.0,
                              127.0).cuda() for _ in range(2))
        ik[..., ::3, :] = -128.0
        for causal in (True, False):
            check_scout(torch, f"hdp_scout {shape} int8 extremes "
                        f"{'causal' if causal else 'full'}", iq, ik,
                        path="tensor_core", rho_b=0.5, block_q=128,
                        block_k=128, causal=causal)
    for path in ("tensor_core", "dp4a"):
        check_scout_bad_input(torch, path)
    scout_hd112(torch)
    for (B, H, S, hd), (bq, bk) in small + [
            ((PREFILL_B, 12, PREFILL_S, 128), (128, 128)),
            (MHA_PREFILL, (128, 128))]:
        for v_bf16 in (False, True):
            c = block_case(torch, B=B, H=H, S=S, hd=hd, bq=bq, bk=bk,
                           v_bf16=v_bf16, seed=11, gate=H > 1)
            label = (f"hdp_block_sparse_attention {(B, H, S, hd)} blocks "
                     f"{bq}x{bk} v {'bf16' if v_bf16 else 'fp32'}")
            check_block(torch, label, c)
    check_block(torch, "hdp_block_sparse_attention decode route "
                "[8,12,1,128] x [8,12,1152,128] blocks 8x128",
                decode_route_case(torch, 21), path="tile")
    for (B, H, S, hd), (bq, bk) in small + [
            ((PREFILL_B, 12, PREFILL_S, 128), (128, 128)),
            (MHA_PREFILL, (128, 128))]:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                if S == PREFILL_S and (dt == torch.float32 or not causal):
                    continue
                q, k, v = (_randn(torch, (B, H, S, hd), s, 2.0).to(dt)
                           for s in (1, 2, 3))
                label = (f"flash_attention {(B, H, S, hd)} blocks {bq}x{bk} "
                         f"{str(dt)[6:]} {'causal' if causal else 'full'}")
                check_flash(torch, label, q, k, v, causal, bq, bk)
    # the tensor-core paths: S not a multiple of the tile, hd 64 and 112
    # (zamba2-7b's, padded to 128 columns in shared memory), non-causal,
    # approx off, kv_len and score_scale, a gated head, and the first
    # row's last q tile listing no block
    g = torch.Generator().manual_seed(17)
    for (B, H, S, hd), (bq, bk), causal, approx in (
            ((1, 3, 4000, 128), (128, 128), True, True),
            ((1, 3, 4000, 128), (128, 128), False, False),
            ((1, 2, 1000, 64), (64, 64), True, True),
            ((1, 2, 1000, 64), (64, 128), False, True),
            ((1, 2, 1000, 128), (128, 64), True, True),
            ((1, 3, 4000, 112), (128, 128), True, True),
            ((1, 3, 4000, 112), (128, 128), False, False),
            ((1, 2, 1000, 112), (64, 128), True, True)):
        c = block_case(torch, B=B, H=H, S=S, hd=hd, bq=bq, bk=bk,
                       v_bf16=True, seed=13, causal=causal)
        c["approx"] = approx
        c["counts"][0, 0, -1] = 0
        extra = ""
        if not causal:
            c["kv_len"] = torch.randint(S // 2, S + 1, (B, H),
                                        generator=g).int().cuda()
            c["score_scale"] = torch.tensor([0.37], device="cuda")
            extra = " kv_len score_scale"
        label = (f"hdp_block_sparse_attention {(B, H, S, hd)} blocks "
                 f"{bq}x{bk} v bf16 {'causal' if causal else 'full'} approx "
                 f"{approx}{extra}, head gated, a q tile listing none")
        check_block(torch, label, c, path="tensor_core")
    for (B, H, S, hd) in ((1, 3, 4000, 128), (1, 2, 1000, 64),
                          (1, 3, 4000, 112), (1, 2, 1000, 112)):
        for causal in (True, False):
            q, k, v = (_randn(torch, (B, H, S, hd), s, 2.0).to(torch.bfloat16)
                       for s in (4, 5, 6))
            label = (f"flash_attention {(B, H, S, hd)} bfloat16 "
                     f"{'causal' if causal else 'full'}")
            check_flash(torch, label, q, k, v, causal, 128, 128,
                        path="tensor_core")
    # the tile paths keep hd 112 in fp32 (bf16 at hd 112 takes the
    # tensor-core kernels above)
    for causal in (True, False):
        c = block_case(torch, B=1, H=2, S=1000, hd=112, bq=128, bk=128,
                       v_bf16=False, seed=19, causal=causal)
        check_block(torch, f"hdp_block_sparse_attention (1, 2, 1000, 112) "
                    f"blocks 128x128 v fp32 "
                    f"{'causal' if causal else 'full'}, head gated", c,
                    path="tile")
        q, k, v = (_randn(torch, (1, 2, 1000, 112), s, 2.0)
                   for s in (7, 8, 9))
        check_flash(torch, f"flash_attention (1, 2, 1000, 112) float32 "
                    f"{'causal' if causal else 'full'}", q, k, v, causal,
                    128, 128, path="tile")


# ------------------------------------------------ phase 4: aligned prefill
class Recorder:
    """Wraps a kernel wrapper; keeps the inputs of the call with the
    largest ``key`` (the last call when key is None; a key of None skips
    the call). With ``clone`` it keeps copies, for a path that later
    rewrites what the call read (a speculative round rolls back and
    poisons pool pages)."""

    def __init__(self, fn, key=None, clone=False):
        self.fn, self.key, self.clone = fn, key, clone
        self.best, self.score = None, None

    def __call__(self, *args, **kw):
        score = 0 if self.key is None else self.key(args)
        if score is not None and (self.score is None or score >= self.score):
            if self.clone:
                args = tuple(a.clone() for a in args)
                kw = {k: (v.clone() if hasattr(v, "clone") else v)
                      for k, v in kw.items()}
            self.best, self.score = (args, kw), score
        return self.fn(*args, **kw)


def listed_pages(args):
    """The pages a FUM-kernel call lists (its counts summed)."""
    return int(args[5].sum())


def listed_pages_verify(args):
    """``listed_pages`` of a verify call (Sq > 1); None for a step."""
    return listed_pages(args) if args[0].shape[3] > 1 else None


def live_blocks(args):
    """The blocks a block-kernel call loads: the listed blocks of kept
    heads (args as the wrapper takes them)."""
    counts, head_kept = args[4], args[5]
    return int((counts * (head_kept[..., None] > 0)).sum())


def _resolved(cfg, **kw):
    from repro_torch.attention import resolve_backend
    from repro_torch.models.attention import build_attn_call
    return resolve_backend(build_attn_call(cfg, **kw)).name


def aligned_prefill(torch, cfg, params, toks, label, n_calls=None,
                    paths=None):
    """``registry.apply_prefill(..., None)`` on ``toks``, HDP on (the
    scout and block kernels) and off (flash), each launched ``n_calls``
    times (default once per layer) on its path in ``paths`` (default the
    tensor-core path of each), each kernel's inputs recorded (the
    scout's and flash's last call, the block call that kept the most
    blocks). Returns (launches per kernel, recorded calls)."""
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.models import registry
    B, S = toks.shape
    paths = paths or dict.fromkeys(("hdp_scout", "hdp_block_sparse_attention",
                                    "flash_attention"), "tensor_core")
    out = {}
    rec = {"scout": Recorder(hdp_scout),
           "block": Recorder(hdp_block_sparse_attention,
                             key=live_blocks),
           "flash": Recorder(flash_attention)}
    ops.hdp_scout, ops.hdp_block_sparse_attention, ops.flash_attention = \
        rec["scout"], rec["block"], rec["flash"]
    try:
        for hdp_on in (True, False):
            c = cfg.replace(hdp=cfg.hdp.replace(enabled=hdp_on))
            backend = _resolved(c, mode="prefill", self_aligned=True)
            check(backend == ("pallas_hdp_block" if hdp_on else
                              "pallas_flash"),
                  f"{label} aligned prefill (HDP {hdp_on}) resolved to "
                  f"{backend}")
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            logits, cache, st = registry.apply_prefill(
                c, params, {"tokens": toks}, None, collect_stats=hdp_on)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {"hdp_scout": hdp_scout.launches,
                 "hdp_block_sparse_attention":
                     hdp_block_sparse_attention.launches,
                 "flash_attention": flash_attention.launches}
            check(cache is None and tuple(logits.shape) ==
                  (B, 1, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"{label} aligned prefill (HDP {hdp_on}): bad logits")
            L = n_calls or cfg.n_layers
            want = ({"hdp_scout": L, "hdp_block_sparse_attention": L,
                     "flash_attention": 0} if hdp_on else
                    {"hdp_scout": 0, "hdp_block_sparse_attention": 0,
                     "flash_attention": L})
            check(n == want, f"{label} aligned prefill (HDP {hdp_on}) "
                  f"launches {n}, expected {want}")
            tc = {k: f.launches_by_path[paths[k]] for k, f in (
                ("hdp_scout", hdp_scout),
                ("hdp_block_sparse_attention", hdp_block_sparse_attention),
                ("flash_attention", flash_attention))}
            check(all(tc[k] == want[k] for k in tc),
                  f"{label} aligned prefill (HDP {hdp_on}): launches on "
                  f"the paths {paths}: {tc}, expected every launch of "
                  f"{want}")
            msg = ""
            if hdp_on:
                msg = (f", block/head sparsity "
                       f"{st['block_sparsity'].mean().item():.4f}/"
                       f"{st['head_sparsity'].mean().item():.4f}")
            where = ("the tensor-core path" if set(paths.values()) ==
                     {"tensor_core"} else f"the paths {paths}")
            log(f"[prefill] {label} B{B} S{S} HDP "
                f"{'on' if hdp_on else 'off'} -> {backend}: {wall:.3f} s, "
                f"launches {n}, on {where} {tc}{msg}")
            out.update({k: v for k, v in n.items() if v})
    finally:
        ops.hdp_scout = hdp_scout
        ops.hdp_block_sparse_attention = hdp_block_sparse_attention
        ops.flash_attention = flash_attention
    return out, {k: r.best for k, r in rec.items()}


def check_prefill_calls(torch, calls, label, paths=None, twin=False):
    """The scout, block and flash kernels against their plain versions at
    the aligned prefill's own recorded inputs, each on its path in
    ``paths`` (default the tensor-core path), the scout with ``twin``
    also against its dp4a kernel. Returns the max |kernel - plain| of
    each (the scout's is 0: bit-equal)."""
    paths = paths or {}
    (iq, ik), kw = calls["scout"]
    errs = {"hdp_scout": check_scout(
        torch, f"hdp_scout at {label}'s last call", iq, ik,
        path=paths.get("hdp_scout", "tensor_core"), twin=twin, **kw)}
    args, kw = calls["block"]
    c = dict(zip(("q", "k", "v", "kv_idx", "counts", "head_kept"), args),
             **{"kv_len": None, "score_scale": None, **kw})
    errs["hdp_block_sparse_attention"] = check_block(
        torch, f"hdp_block_sparse_attention at {label}'s call that kept "
        f"the most blocks ({live_blocks(args)})", c,
        path=paths.get("hdp_block_sparse_attention", "tensor_core"))
    (q, k, v), kw = calls["flash"]
    errs["flash_attention"] = check_flash(
        torch, f"flash_attention at {label}'s last call", q, k, v,
        kw["causal"], kw["block_q"], kw["block_k"],
        path=paths.get("flash_attention", "tensor_core"))
    return errs


def phase_aligned_prefill(torch, cfg, params):
    """qwen2-1.5b at full width, B 2, S 4096: HDP on through the scout and
    block kernels, HDP off through flash, each launched once per layer;
    kernel vs plain at the path's own inputs; the reduced config's
    aligned-prefill logits on the card vs the CPU."""
    import numpy as np
    import repro_torch.kernels.ops as ops
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.models import registry
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()
    out, calls = aligned_prefill(torch, cfg, params, toks, "qwen2-1.5b")
    check_prefill_calls(torch, calls, "the path")
    (iq, ik), kw = calls["scout"]
    check_scout(torch, "hdp_scout, the dp4a kernel, at the path's last call",
                iq, ik, path="dp4a", force="dp4a", **kw)

    # the reduced config's aligned prefill: card (kernels) vs CPU (plain),
    # in fp32 (atol 1e-4) and in bf16, where the block kernel's fp32
    # output meets bf16 wo in fp32 and is rounded to bf16 (2e-2); hd 16
    # and 2x2 blocks take the tile kernels and the dp4a scout. The fp32
    # runs are the paths of the tile flash kernel (HDP off) and the dp4a
    # scout (HDP on): their launches are counted.
    stoks = torch.from_numpy(np.random.default_rng(6).integers(
        1, reduced(cfg).vocab_size, (2, 18)))
    for dtype, tol in (("float32", (ATOL, 0.0)),
                       ("bfloat16", (TOL_BF16, TOL_BF16))):
        small = reduced(cfg).replace(dtype=dtype)
        sp = registry.init_params(small, 1, "cuda")
        sp_cpu = _tree_to(sp, "cpu")
        for hdp_on in (True, False):
            c = small.replace(hdp=small.hdp.replace(enabled=hdp_on))
            zero_launches()
            ops.hdp_scout = small_scout = Recorder(hdp_scout)
            try:
                lg, _, sg = registry.apply_prefill(
                    c, sp, {"tokens": stoks.cuda()}, None,
                    collect_stats=hdp_on)
            finally:
                ops.hdp_scout = hdp_scout
            if dtype == "float32" and hdp_on:
                dp4a = hdp_scout.launches_by_path["dp4a"]
                check(dp4a == small.n_layers == hdp_scout.launches,
                      f"reduced fp32 aligned prefill: scout launches "
                      f"{hdp_scout.launches_by_path}, expected "
                      f"{small.n_layers} on the dp4a path")
                (iq, ik), kw = small_scout.best
                check_scout(torch, "hdp_scout at the reduced prefill's last "
                            "call", iq, ik, path="dp4a", **kw)
            if dtype == "float32" and not hdp_on:
                tile_flash = flash_attention.launches_by_path["tile"]
                check(tile_flash == small.n_layers == flash_attention.launches,
                      f"reduced fp32 aligned prefill: flash launches "
                      f"{flash_attention.launches_by_path}, expected "
                      f"{small.n_layers} on the tile path")
            lc, _, sc = registry.apply_prefill(
                c, sp_cpu, {"tokens": stoks}, None, collect_stats=hdp_on)
            err = (lg.cpu() - lc).abs().max().item()
            backend = _resolved(c, mode="prefill", self_aligned=True)
            msg = ""
            if hdp_on:
                msg = (", block sparsity card/CPU "
                       f"{sg['block_sparsity'].mean().item():.4f}/"
                       f"{sc['block_sparsity'].mean().item():.4f}")
            check(lg.dtype == torch.float32 and torch.allclose(
                lg.cpu(), lc, atol=tol[0], rtol=tol[1]),
                f"reduced {dtype} aligned prefill (HDP {hdp_on}): card vs "
                f"CPU logits max |err| {err:.3e}{msg}")
            log(f"[prefill] reduced qwen2-1.5b {dtype} aligned prefill HDP "
                f"{'on' if hdp_on else 'off'} ({backend}): card vs CPU "
                f"logits max |err| {err:.3e} (max |logit| "
                f"{lc.abs().max().item():.3e}){msg}")
    out["flash_attention[tile]"] = tile_flash
    out["hdp_scout[dp4a]"] = dp4a
    return out, calls


def zero_launches():
    """Sets every kernel wrapper's launch counts, and the kernels' own
    counts of their runs on the card, to 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.hdp_scout import hdp_scout
    for fn in (hdp_paged_fum_decode, hdp_scout, hdp_block_sparse_attention,
               flash_attention):
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    hdp_paged_fum_decode.launches_by_format = dict.fromkeys(
        hdp_paged_fum_decode.launches_by_format, 0)
    hdp_paged_fum_decode.runs.zero()
    hdp_block_sparse_attention.runs.zero()


# ------------------------------------------------------------ phase 5
def kernel_counts(torch):
    """After the card finishes: the FUM and block wrappers' launches by
    path (and the FUM's by pool format), and the runs of the FUM and the
    block tile kernel on the card by their own counts (the only count of
    what a graph's replays ran), since the last ``zero_launches``."""
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    torch.cuda.synchronize()
    return ({"fum": dict(hdp_paged_fum_decode.launches_by_path),
             "block": dict(hdp_block_sparse_attention.launches_by_path),
             "fum_format": dict(hdp_paged_fum_decode.launches_by_format)},
            {"fum": hdp_paged_fum_decode.runs.read(),
             "block": hdp_block_sparse_attention.runs.read()})


SERVE_KW = dict(max_batch=8, max_len=1056, prefill_buckets=(256, 512, 1024),
                collect_stats=True)
LONG_PROMPTS, LONG_MAX_LEN = (2500, 4000), 4128


def serve_requests(torch, eng, reqs, *, arrive_after=0, late=(),
                   faulted=()):
    """Serve the Requests ``reqs`` through ``eng`` with every launch count
    zeroed first; ``late`` is submitted after ``arrive_after`` engine
    steps. Every request but the uids in ``faulted`` (which an injected
    fault targets) must complete with tokens in the vocabulary.
    Returns (tokens by uid, Results, summary, wall s, FUM and block
    wrapper launches by path (and the FUM's by pool format), and the
    runs of the FUM and the block tile kernel on the card over the whole
    serve, by their own counts: the only count of what a graph's replays
    ran)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(arrive_after):
        eng.step()
    for r in late:
        eng.submit(r)
    res = eng.run(strict=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, runs = kernel_counts(torch)
    check(len(res) == len(reqs) + len(late) and all(
        r.complete and r.status == "ok"
        and all(0 <= t < eng.cfg.vocab_size for t in r.tokens)
        for u, r in res.items() if u not in faulted),
        f"not every request completed: "
        f"{[(u, r.status, r.error, len(r.tokens)) for u, r in res.items()]}")
    return ({u: r.tokens for u, r in res.items()}, res, eng.summary(), wall,
            launches, runs)


def serve(torch, eng, prompts, max_new):
    """``serve_requests`` of ``prompts`` (uids in order), each with
    ``max_new`` tokens. Returns (tokens by uid, summary, wall s, wrapper
    launches, runs on the card)."""
    from repro_torch.serving import Request
    tok, _, s, wall, launches, runs = serve_requests(
        torch, eng, [Request(u, p, max_new_tokens=max_new)
                     for u, p in enumerate(prompts)])
    check(all(len(t) == max_new for t in tok.values()),
          f"not every request made {max_new} tokens: "
          f"{ {u: len(t) for u, t in tok.items()} }")
    return tok, s, wall, launches, runs


def check_decode_launches(s, launches, kernel, label, runs,
                          n_layers=N_LAYERS_QWEN):
    """The engine counts ``n_layers`` launches of ``kernel`` ("fum" or
    "block") per decode step and none of the other. Eagerly the wrapper
    counts the same. Graphed, the wrapper is called twice per layer and capture:
    the eager warm-up step and the capture, which records the kernel
    and runs nothing; the replays never call it. The kernel's own count
    of its runs on the card (``runs``) must be the engine's plus the
    warm-up step's: the launches the replays really ran."""
    other = "block" if kernel == "fum" else "fum"
    steps, caps = s["decode_steps"], s["graph_captures"]
    n = s[f"{kernel}_kernel_launches"]
    wrapper = sum(launches[kernel].values())
    want_wrapper = 2 * n_layers * caps if caps else n
    check(n == n_layers * steps and n > 0
          and s[f"{other}_kernel_launches"] == 0
          and not any(launches[other].values()),
          f"{label}: {kernel} kernel launched {n} times by the decode steps "
          f"(other kernel {s[f'{other}_kernel_launches']}), expected "
          f"{n_layers} x {steps} decode steps")
    check(wrapper == want_wrapper,
          f"{label}: the {kernel} wrapper counted {wrapper} launches, "
          f"expected {want_wrapper}")
    want = n + n_layers * caps
    check(runs[kernel] == want and runs[other] == 0,
          f"{label}: the kernels counted {runs} runs on the card, expected "
          f"{want} of {kernel} ({n_layers} layers x {steps} decode steps + "
          f"{caps} warm-up step(s)) and none of {other}")
    log(f"[serve] {label}: {runs[kernel]} runs of the {kernel} kernel on "
        f"the card = {n_layers} layers x ({steps} decode steps + {caps} "
        f"warm-up step(s)), the engine counted {n} for the steps, the "
        f"wrapper {launches[kernel]}")


def log_served(label, s, wall):
    log(f"[serve] {label}: wall {wall:.2f} s, prefill_s "
        f"{s['prefill_s']:.3f}, decode_tok_s {s['decode_tok_s']:.1f} "
        f"(without the graph's capture {s['decode_tok_s_steady']:.1f}), "
        f"decode_steps {s['decode_steps']}, decode_horizon "
        f"{s['decode_horizon']}, cuda_graph {s['cuda_graph']}, FUM/block "
        f"launches {s['fum_kernel_launches']}/{s['block_kernel_launches']}, "
        f"block/head/page sparsity {s['block_sparsity']:.4f}/"
        f"{s['head_sparsity']:.4f}/{s['page_sparsity']:.4f}")
    if s["graph_captures"]:
        log(f"[serve] {label}: decode graph captured "
            f"{s['graph_captures']}x in {s['graph_capture_s']:.3f} s "
            "(with its eager warm-up step), memory it holds: allocated "
            f"{s['graph_allocated_bytes'] / 2**20:.2f} MiB, reserved "
            f"{s['graph_reserved_bytes'] / 2**20:.2f} MiB")


def phase_serving(torch, cfg, params):
    """The serving traffic eagerly (the FUM kernel recorded and held
    against its plain version at the path's call that listed the most
    pages), then on the decode graph at horizons 1 and 4 (tokens equal
    the eager run's, launches 28 per step, cross-checked by the kernel's
    count on the card); the block decode route eagerly and graphed; chunked
    prefill of 2,500 and 4,000 tokens; the reduced config graphed on the
    card against the CPU, with a chunked prompt."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.configs import reduced
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    from repro_torch.serving import Engine, Request
    rng = np.random.default_rng(0)
    prompts = serving_prompts(cfg, rng)
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}")
    out = {}

    # eagerly, keeping the inputs of the FUM call of the path that
    # listed the most pages, to hold the kernel against its plain version
    # there; a graph's replays would overwrite the recorded buffers
    rec = Recorder(hdp_paged_fum_decode, key=listed_pages, clone=True)
    eng = Engine(cfg, params, device="cuda", cuda_graph=False, **SERVE_KW)
    torch.cuda.reset_peak_memory_stats()
    attention.hdp_paged_fum_decode = rec
    try:
        eager_tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
    finally:
        attention.hdp_paged_fum_decode = hdp_paged_fum_decode
    del eng
    eager_tok_s = s["decode_tok_s"]
    log_served("eager, horizon 1", s, wall)
    log(f"[serve] summary {json.dumps(s, default=str)}")
    log(f"[serve] cache_bytes_per_token {s['cache_bytes_per_token']}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(s["attn_decode_stage3"].startswith("cuda"),
          f"decode stage 3 resolved to {s['attn_decode_stage3']}")
    check_decode_launches(s, launches, "fum", "eager", runs)
    check(launches["fum"]["split"] == s["fum_kernel_launches"],
          f"FUM launches by mode {launches['fum']}: expected every launch "
          "split across blocks")
    log(f"[serve] eager: FUM kernel launches {s['fum_kernel_launches']} = "
        f"{N_LAYERS_QWEN} layers x {s['decode_steps']} decode steps, by "
        f"mode {launches['fum']}")
    check(rec.score > 0, "no FUM call of the path listed a page")
    (args, kw), rec = rec.best, None
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    path_err = {}
    for mode, splits in (("split", None), ("single", 1)):
        got = hdp_paged_fum_decode(*args, **kw, splits=splits)
        torch.cuda.synchronize()
        path_err[mode] = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=ATOL, rtol=RTOL),
            f"kernel [{mode}] vs plain at the path's own inputs: max |err| "
            f"{path_err[mode]:.3e}")
    log(f"[serve] kernel vs plain at the path's call that listed the most "
        f"pages (qq {tuple(args[0].shape)}, page lists "
        f"{tuple(args[3].shape)}, {listed_pages(args)} pages listed): max "
        f"|err| {path_err}")
    del args, kw, ref

    # the main path: the decode step as one CUDA graph, horizons 1 and 4
    for horizon in (1, 4):
        eng = Engine(cfg, params, device="cuda", decode_horizon=horizon,
                     **SERVE_KW)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng
        label = f"graphed, horizon {horizon}"
        log_served(label, s, wall)
        check(tok == eager_tok, f"{label}: tokens differ from the eager "
              f"run's: {tok} vs {eager_tok}")
        if horizon == 1:
            out["h1_tokens"] = tok
            out["cache_bytes_pool"] = s["cache_bytes_pool"]
        check(s["graph_captures"] == 1, f"{label}: {s['graph_captures']} "
              "graph captures, expected 1")
        check_decode_launches(s, launches, "fum", label, runs)
        check(launches["fum"]["split"] == sum(launches["fum"].values()),
              f"{label}: FUM launches by mode {launches['fum']}: expected "
              "every launch split across blocks")
        log(f"[serve] {label}: tokens == the eager run's; FUM kernel "
            f"launches {s['fum_kernel_launches']} = {N_LAYERS_QWEN} layers "
            f"x {s['decode_steps']} decode steps")
        check(s["decode_tok_s"] > eager_tok_s,
              f"{label}: decode_tok_s {s['decode_tok_s']:.1f} is not above "
              f"the eager run's {eager_tok_s:.1f}")
        if horizon == 1:
            # every wrapper call was split, so the single mode ran nothing
            out["fum"] = {"split": runs["fum"],
                          "single": launches["fum"]["single"]}

    # the paged decode through the block-sparse kernel on a densified
    # gather: once per layer per decode step, FUM kernel not at all;
    # eagerly (recorded), then graphed at horizon 4
    block_tok = {}
    for graphed in (False, True):
        beng = Engine(cfg, params, device="cuda", attn="pallas_hdp_block",
                      cuda_graph=graphed, decode_horizon=4 if graphed else 1,
                      **SERVE_KW)
        check(beng.resolved_backend("decode") == "pallas_hdp_block",
              f"attn=pallas_hdp_block decode resolved to "
              f"{beng.resolved_backend('decode')}")
        if not graphed:
            rec = Recorder(hdp_block_sparse_attention, key=live_blocks)
            attention.hdp_block_sparse_attention = rec
        try:
            block_tok[graphed], bs, wall, launches, runs = serve(
                torch, beng, prompts, 16)
        finally:
            attention.hdp_block_sparse_attention = hdp_block_sparse_attention
        del beng
        label = ("attn=pallas_hdp_block, "
                 + ("graphed, horizon 4" if graphed else "eager, horizon 1"))
        log_served(label, bs, wall)
        check(bs["attn_decode_stage3"] == "cuda:hdp_block_sparse_attention",
              f"decode stage 3 resolved to {bs['attn_decode_stage3']}")
        check_decode_launches(bs, launches, "block", label, runs)
        check(launches["block"]["tile"] == sum(launches["block"].values()),
              f"{label}: block launches {launches['block']}, expected all "
              "on the tile path")
        log(f"[serve] {label}: block kernel launches (tile path) "
            f"{bs['block_kernel_launches']} = {N_LAYERS_QWEN} layers x "
            f"{bs['decode_steps']} decode steps")
        if graphed:
            out["block_tile"] = runs["block"]
    check(block_tok[True] == block_tok[False],
          "attn=pallas_hdp_block: graphed tokens differ from the eager run's")
    log("[serve] attn=pallas_hdp_block: graphed horizon-4 tokens == eager")
    check(rec.score > 0, "no block-kernel call of the decode route loaded "
          "a block")
    args, kw = rec.best
    c = dict(zip(("q", "k", "v", "kv_idx", "counts", "head_kept"), args),
             **kw)
    check_block(
        torch, f"hdp_block_sparse_attention at the decode route's call that "
        f"kept the most blocks ({rec.score}; q {tuple(args[0].shape)}, "
        f"k/v {tuple(args[1].shape)})", c, path="tile")

    # chunked prefill at full width: 1,024-token chunks plus the tail
    long_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                    for n in LONG_PROMPTS]
    leng = Engine(cfg, params, device="cuda", max_batch=2,
                  max_len=LONG_MAX_LEN, prefill_buckets=(256, 512, 1024),
                  decode_horizon=4, collect_stats=True)
    chunks = []
    chunk_step = leng._chunk_step

    def counting(prompt, cache, off):
        nxt = chunk_step(prompt, cache, off)
        chunks.append((len(prompt), off, nxt - off))
        return nxt

    leng._chunk_step = counting
    _, ls, wall, launches, runs = serve(torch, leng, long_prompts, 32)
    del leng._chunk_step   # the closure holds the engine: free it with del
    del leng
    want = []
    for n in LONG_PROMPTS:
        off = 0
        while off < n:
            clen = 1024 if n - off >= 1024 else next(
                b for b in (256, 512, 1024) if b >= n - off)
            want.append((n, off, clen))
            off += clen
    log_served(f"chunked prefill of {list(LONG_PROMPTS)} tokens", ls, wall)
    check(chunks == want and ls["prefill_calls"] == 2
          and ls["prefill_tokens"] == sum(c for *_, c in want),
          f"chunked prefill ran chunks {chunks} ({ls['prefill_calls']} "
          f"prefills, {ls['prefill_tokens']} tokens), expected {want}")
    check_decode_launches(ls, launches, "fum", "chunked prefill", runs)
    log(f"[serve] chunked prefill: {len(chunks)} chunk calls "
        f"(prompt, offset, length) {chunks}, prefill_s "
        f"{ls['prefill_s']:.3f}, both requests complete")

    # agreement with a reference on a small input: the reduced config
    # graphed at horizon 4 on the card (kernels) and on the CPU (plain
    # versions), same weights, one prompt chunked (40 > bucket 32)
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    gpu = Engine(small, device="cuda", seed=1, decode_horizon=4, **kw)
    cpu_params = {k: _tree_to(v, "cpu") for k, v in gpu.params.items()}
    cpu = Engine(small, cpu_params, device="cpu", **kw)
    prng = np.random.default_rng(3)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(4)] + [prng.integers(1, 250, size=40).tolist()]
    toks = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
    check(gpu.metrics["graph_captures"] == 1 and
          gpu.metrics["prefill_calls"] == cpu.metrics["prefill_calls"],
          f"reduced qwen2: card engine {gpu.metrics}")
    check(toks[0] == toks[1], f"reduced qwen2 tokens differ card vs CPU: "
          f"{toks[0]} vs {toks[1]}")
    log("[serve] reduced qwen2-1.5b (one prompt of 40 tokens chunked): "
        "card tokens (graphed, horizon 4) == CPU plain-path tokens")
    return out, path_err, rec.best


# ------------------------- phase 5d: prefix cache and speculative decode
PREFIX_KW = dict(max_batch=8, max_len=2048, prefill_buckets=(256, 512, 1024),
                 decode_horizon=4)
SHARED_LEN = 1024
#: the draft lengths of the graphed speculative serves
DRAFT_LENS = (4, 8)
#: depth of the fp32-pool speculative run (qwen2-1.5b cut to it)
FP32_POOL_LAYERS = 8


def prefix_traffic(vocab):
    """Seed 0: a 1,024-token shared prompt; the warm-up request (the
    prompt and a 64-token tail), then 6 requests of the prompt and
    distinct tails of 32-480 tokens (chunked: past the largest bucket),
    and 2 that are exactly its first 512 and 1,024 tokens (full hits)."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, size=SHARED_LEN).tolist()
    warm = shared + rng.integers(1, vocab, size=64).tolist()
    tails = [shared + rng.integers(1, vocab, size=int(n)).tolist()
             for n in rng.integers(32, 481, size=6)]
    return warm, tails + [shared[:512], shared[:SHARED_LEN]]


def serve_prefix(torch, cfg, params, prefix_cache):
    """The prefix traffic through one engine: the warm-up request alone,
    then the 8 others. Returns (tokens of all 9, summary, engine)."""
    from repro_torch.serving import Engine, Request
    eng = Engine(cfg, params, device="cuda", prefix_cache=prefix_cache,
                 **PREFIX_KW)
    warm, rest = prefix_traffic(cfg.vocab_size)
    eng.submit(Request(0, warm, max_new_tokens=32))
    eng.run()
    for uid, p in enumerate(rest, start=1):
        eng.submit(Request(uid, p, max_new_tokens=32))
    res = eng.run()
    torch.cuda.synchronize()
    check(len(res) == 9 and all(r.complete and len(r.tokens) == 32
                                for r in res.values()),
          f"prefix traffic: not every request completed: "
          f"{[(u, r.status, len(r.tokens)) for u, r in res.items()]}")
    return {u: r.tokens for u, r in res.items()}, eng.summary(), eng


def single_step_lists(torch, args, j):
    """The inputs of the single decode step at verify row j: row j's
    query, its keep flags, its extent, and the page list restricted to
    the pages some head keeps for row j (ascending, scratch-padded)."""
    qq, kp, vp, page_ids, logical, counts, keep, kv_len = args
    B, mk = page_ids.shape
    listed = torch.arange(mk, device=page_ids.device)[None] < counts[:, None]
    mine = listed & (keep[..., j] > 0).flatten(2).any(-1)          # [B,mk]
    order = torch.sort(torch.where(mine, torch.arange(
        mk, device=mine.device)[None], mk), dim=1).values
    cnt = mine.sum(1).to(torch.int32)
    valid = torch.arange(mk, device=mine.device)[None] < cnt[:, None]
    idx = torch.clamp(order, max=mk - 1).long()
    pick = lambda t: torch.where(valid, torch.gather(t, 1, idx), 0).to(
        torch.int32).contiguous()
    keep_j = torch.gather(keep[..., j:j + 1], 1, idx[:, :, None, None, None]
                          .expand(-1, -1, *keep.shape[2:4], 1))
    keep_j = torch.where(valid[:, :, None, None, None], keep_j, 0)
    return (qq[:, :, :, j:j + 1].contiguous(), kp, vp, pick(page_ids),
            pick(logical), cnt.contiguous(), keep_j.contiguous(),
            (kv_len + j).to(torch.int32).contiguous())


def check_verify_call(torch, label, rec):
    """The FUM kernel at the path's recorded verify call against its plain
    version (phase 3's tolerances), and each of its rows bit-equal to
    the single step at that row's position. Returns max |err|."""
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    check(rec.best is not None and rec.score > 0,
          f"{label}: no verify call of the path listed a page")
    args, kw = rec.best
    Sq = args[0].shape[3]
    tol = ATOL if args[2].dtype == torch.int8 else TOL_BF16
    got = hdp_paged_fum_decode(*args, **kw)
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got, ref, atol=tol, rtol=tol),
        f"{label}: kernel vs plain at the verify call: max |err| {err:.3e}")
    worst = 0.0
    for j in range(Sq):
        one = hdp_paged_fum_decode(*single_step_lists(torch, args, j), **kw)
        worst = max(worst, (got[:, :, :, j] - one[:, :, :, 0]).abs().max()
                    .item())
    check(worst == 0.0, f"{label}: verify rows differ from the single "
          f"steps at their positions by up to {worst:.3e}")
    log(f"[spec] {label}: FUM kernel vs plain at the verify call that "
        f"listed the most pages (qq {tuple(args[0].shape)}, {rec.score} "
        f"pages listed): max |err| {err:.3e}; each of its {Sq} rows "
        "bit-equal to the single step at its position")
    return err


def key_names(by_key):
    """A dict keyed by the engine's graph keys ("decode", or a round's
    (k, tier)) as {"k" or "k:tier": value}, in key order."""
    from repro_torch.serving.engine import _key_name
    return {_key_name(k): v for k, v in sorted(by_key.items(), key=str)}


def first_divergence(a, b):
    """Per request: (first index where the token lists differ, the two
    tokens) for the requests whose lists differ."""
    out = {}
    for u in a:
        if a[u] != b[u]:
            i = next((i for i, (x, y) in enumerate(zip(a[u], b[u]))
                      if x != y), min(len(a[u]), len(b[u])))
            out[u] = (i, a[u][i:i + 1], b[u][i:i + 1])
    return out


def phase_spec_prefix(torch, cfg, params, h1_tokens):
    """qwen2-1.5b at full width: the prefix traffic hot and cold (head
    pruning off, the reference's identity setting) with equal tokens, 8
    hits, 2 COWs and a drained pool, then hot on the stock config;
    speculative decode, graphed, at draft lengths 4 and 8 on phase 5's
    traffic with the graphed horizon-1 engine's tokens (``h1_tokens``),
    the FUM kernel 28 times a verify and never in a draft step, held
    against its plain version at the path's verify call; the fp32
    ("model dtype") pool with its fraction copy, cut to 8 layers; the
    reduced config with both features, card vs CPU. Returns
    {draft_len: (launches at that width, max |err|)}."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.attention import AttnSpec
    from repro_torch.configs import reduced
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.serving import Engine, Request

    # ---- prefix cache: hot equals cold with the head gate off
    nogate = cfg.replace(hdp=cfg.hdp.replace(head_pruning=False))
    cold_tok, cs, _ = serve_prefix(torch, nogate, params, False)
    hot_tok, hs, heng = serve_prefix(torch, nogate, params, True)
    bad = first_divergence(hot_tok, cold_tok)
    check(not bad, f"prefix hit tokens differ from cold (uid: first index, "
          f"hot, cold): {bad}")
    check(hs["prefix_hits"] == 8 and hs["cow_copies"] >= 2,
          f"prefix cache: {hs['prefix_hits']} hits and {hs['cow_copies']} "
          "COW copies, expected 8 and >= 2")
    heng.prefix.clear()
    heng.pages.allocator.assert_drained()
    del heng
    log(f"[prefix] head gate off: 9 requests' tokens hot == cold; hits "
        f"{hs['prefix_hits']}, hit tokens {hs['prefix_hit_tokens']}, COW "
        f"copies {hs['cow_copies']}, pages cached {hs['pages_cached']}, "
        f"pool drained after clear(); prefill_s hot {hs['prefill_s']:.3f} "
        f"vs cold {cs['prefill_s']:.3f} (prefill tokens "
        f"{hs['prefill_tokens']} vs {cs['prefill_tokens']}, calls "
        f"{hs['prefill_calls']} vs {cs['prefill_calls']})")
    _, ss, seng = serve_prefix(torch, cfg, params, True)
    del seng
    log(f"[prefix] stock config (head pruning on): hits "
        f"{ss['prefix_hits']}, prefill_s {ss['prefill_s']:.3f}, decode "
        f"tok/s {ss['decode_tok_s']:.1f}")

    # ---- speculative decode at full width, graphed
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    out = {}
    for k in DRAFT_LENS:
        eng = Engine(cfg, params, device="cuda", spec_decode=True,
                     draft_len=k, **SERVE_KW)
        # (key, FUM runs before, after) per round: the runs between are
        # that round's, its capture's warm-up included
        rounds = count_rounds(torch, eng)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng._run       # the closure holds the engine: free it with del
        label = f"spec decode, draft_len {k}, graphed"
        bad = first_divergence(tok, h1_tokens)
        check(not bad, f"{label}: tokens differ from the graphed horizon-1 "
              f"engine's (uid: first index, spec, horizon 1): {bad}")
        check(s["attn_decode_stage3"] == s["attn_verify_stage3"]
              == "cuda:hdp_paged_fum_decode",
              f"{label}: verify stage 3 resolved to "
              f"{s['attn_verify_stage3']}")
        rl = s["round_launches"]
        # keyed (k, tier): a fixed draft profile is the "base" tier
        graphs = {w: n for w, (_, n) in eng._graphs.items()}
        check(all(v["draft"]["fum_kernel_launches"] == 0
                  and v["verify"]["fum_kernel_launches"] == N_LAYERS_QWEN
                  for v in rl.values())
              and all(g["fum_kernel_launches"] == N_LAYERS_QWEN
                      for g in graphs.values())
              and s["fum_kernel_launches"] == N_LAYERS_QWEN
              * s["spec_rounds"],
              f"{label}: FUM launches per round part {rl}, per graph "
              f"{graphs}, {s['fum_kernel_launches']} over "
              f"{s['spec_rounds']} rounds; expected {N_LAYERS_QWEN} a "
              "verify and none in the draft steps")
        # the FUM kernel's runs on the card, by the width of the round
        # they ran in: each round replays its width's graph, and the
        # first round of a width also runs the capture's warm-up
        widths, per_width = [w for w, _, _ in rounds], Counter()
        for w, before, after in rounds:
            per_width[w] += int((after - before).item())
        del rounds
        want = {w: graphs[w]["fum_kernel_launches"] * (widths.count(w) + 1)
                for w in set(widths)}
        want_all = N_LAYERS_QWEN * (s["spec_rounds"] + s["graph_captures"])
        check(per_width == want and runs["fum"] == want_all
              == sum(per_width.values()) and runs["block"] == 0,
              f"{label}: the kernel counted {runs['fum']} FUM runs on the "
              f"card, {dict(per_width)} by round width, over "
              f"{len(widths)} rounds; the engine counted {want} (its "
              f"graph's launches x (rounds + 1 warm-up)), {want_all} in "
              f"all ({N_LAYERS_QWEN} x ({s['spec_rounds']} rounds + "
              f"{s['graph_captures']} warm-up rounds)); block tile runs "
              f"{runs['block']}")
        log(f"[spec] {label}: {runs['fum']} FUM runs on the card = "
            f"{N_LAYERS_QWEN} layers x ({s['spec_rounds']} verifies + "
            f"{s['graph_captures']} warm-up rounds), by round width "
            f"{key_names(per_width)} = the engine's count")
        check(s["spec_graphs"] == len(set(widths)) <= k
              and s["graph_captures"] == s["spec_graphs"],
              f"{label}: {s['spec_graphs']} graphs for widths "
              f"{sorted(set(widths), key=str)}")
        log(f"[spec] {label}: "
            f"tokens == graphed horizon 1's; wall {wall:.2f} s, rounds "
            f"{s['spec_rounds']} (widths {key_names(Counter(widths))}), "
            f"acceptance_rate {s['acceptance_rate']:.4f}, decode_tok_s "
            f"{s['decode_tok_s']:.1f} (without the captures "
            f"{s['decode_tok_s_steady']:.1f}), graphs {s['spec_graphs']} "
            f"captured in {s['graph_capture_s']:.2f} s holding "
            f"{s['graph_allocated_bytes'] / 2**20:.1f} MiB allocated / "
            f"{s['graph_reserved_bytes'] / 2**20:.1f} MiB reserved; FUM "
            f"launches per round: draft "
            f"{rl[f'{k}:base']['draft']['fum_kernel_launches']}, verify "
            f"{rl[f'{k}:base']['verify']['fum_kernel_launches']}; backends "
            f"draft {s['attn_backend_draft']} ({s['attn_draft_stage3']}), "
            f"verify {s['attn_backend_verify']}")
        # the kernel's runs at Sq = k on the card
        launched = per_width[(k, "base")]
        del eng
        # the FUM kernel at the path's own verify calls: the same serve
        # eagerly, recording the call that listed the most pages
        eng = Engine(cfg, params, device="cuda", spec_decode=True,
                     draft_len=k, cuda_graph=False, **SERVE_KW)
        rec = Recorder(hdp_paged_fum_decode, key=listed_pages_verify,
                       clone=True)
        attention.hdp_paged_fum_decode = rec
        try:
            etok, es, ewall, _, eruns = serve(torch, eng, prompts, 32)
        finally:
            attention.hdp_paged_fum_decode = hdp_paged_fum_decode
        del eng
        check(etok == tok, f"draft_len {k}: eager tokens differ from the "
              "graphed run's")
        check(eruns["fum"] == es["fum_kernel_launches"]
              == N_LAYERS_QWEN * es["spec_rounds"],
              f"draft_len {k}, eager: {eruns['fum']} FUM runs on the card, "
              f"the engine counted {es['fum_kernel_launches']} over "
              f"{es['spec_rounds']} rounds")
        log(f"[spec] draft_len {k}, eager: tokens == graphed; decode_tok_s "
            f"{es['decode_tok_s']:.1f}, rounds {es['spec_rounds']}")
        out[k] = (launched, check_verify_call(
            torch, f"draft_len {k}", rec))
        del rec

    # ---- the model-dtype ("fp32") pool and its fraction copy, 8 layers
    nl = FP32_POOL_LAYERS
    cut = cfg.replace(n_layers=nl)
    p8 = {**params, "layers": _tree_map(lambda t: t[:nl], params["layers"])}
    runs = {}
    for spec in (False, True):
        eng = Engine(cut, p8, device="cuda", attn=AttnSpec(kv_dtype="fp32"),
                     spec_decode=spec, draft_len=4, **SERVE_KW)
        runs[spec] = serve(torch, eng, prompts, 32)[:2]
        if spec:
            check("f_scout" in eng.pages.cache,
                  "the speculating fp32 pool has no fraction copy")
        del eng
    bad = first_divergence(runs[True][0], runs[False][0])
    check(not bad, f"fp32 pool, {nl} layers: spec tokens differ from "
          f"horizon 1's: {bad}")
    log(f"[spec] fp32 (bf16) pool with f_scout, {nl} layers, draft_len 4: "
        f"tokens == horizon 1's; acceptance_rate "
        f"{runs[True][1]['acceptance_rate']:.4f}, cache_bytes_per_token "
        f"{runs[True][1]['cache_bytes_per_token']} (without the fraction "
        f"copy {runs[False][1]['cache_bytes_per_token']})")

    # ---- the reduced config, both features, card (graphed) vs CPU
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=96, prefill_buckets=(16, 32),
              prefix_cache=True, spec_decode=True, draft_len=4)
    gpu = Engine(small, device="cuda", seed=1, **kw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **kw)
    prng = np.random.default_rng(17)
    shared = prng.integers(1, 250, size=16).tolist()
    sp = [shared + prng.integers(1, 250, size=4 + i).tolist()
          for i in range(3)] + [shared[:12],
                                shared * 2 + prng.integers(1, 250, 8).tolist()]
    toks, sums = [], []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
        sums.append(e.summary())
    check(toks[0] == toks[1], f"reduced qwen2 with prefix cache and spec "
          f"decode: card tokens differ from the CPU's: {toks[0]} vs "
          f"{toks[1]}")
    check(sums[0]["prefix_hits"] == sums[1]["prefix_hits"] > 0
          and sums[0]["spec_graphs"] > 0,
          f"reduced qwen2: card {sums[0]['prefix_hits']} hits, "
          f"{sums[0]['spec_graphs']} graphs; CPU {sums[1]['prefix_hits']}")
    log(f"[spec] reduced qwen2-1.5b, prefix cache + spec decode (draft_len "
        f"4, one prompt chunked): card tokens (graphed) == CPU tokens; "
        f"hits {sums[0]['prefix_hits']}, acceptance_rate "
        f"{sums[0]['acceptance_rate']:.4f}")
    return out


# ------------------------------ phase 5f: the stream scheduler, item 5
#: phase 5f's traffic: 24 requests of 200-1,000 prompt tokens, 32 new
STREAM_REQUESTS = 24
#: (c): the low-priority requests' budget and the steps before the two
#: high-priority ones arrive
PREEMPT_NEW, PREEMPT_AFTER_STEPS = 96, 3


def log_sched(label, s):
    """The scheduler's counters and the request timings of a serve (host
    read granularity: one read per horizon)."""
    sched = ""
    if s["stream_sched"]:
        sched = (f"admitted {s['sched_admitted']}, recycled "
                 f"{s['sched_recycled']}, deferred {s['sched_deferred']}, "
                 f"preempted {s['sched_preempted']}, chunk tokens "
                 f"{s['sched_chunk_tokens']}, interleaved steps "
                 f"{s['sched_interleaved_steps']}, host time in ticks "
                 f"outside prefill {s['sched_tick_s'] - s['prefill_s']:.4f} "
                 f"s over {s['sched_ticks']} ticks; ")
    log(f"[sched] {label}: {sched}TTFT p50/p95/mean "
        f"{s.get('ttft_s_p50', float('nan')):.4f}/"
        f"{s.get('ttft_s_p95', float('nan')):.4f}/"
        f"{s.get('ttft_s_mean', float('nan')):.4f} s, TPOT mean "
        f"{s.get('tpot_s_mean', float('nan')) * 1e3:.3f} ms, queue wait "
        f"mean {s.get('queue_wait_s_mean', float('nan')):.4f} s, queue "
        f"depth mean/peak {s.get('queue_depth_mean', 0.0):.3f}/"
        f"{s['queue_depth_peak']}")


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def top2_margin(torch, cfg, params, prompt, tokens, i):
    """The top-2 logit margin where a greedy stream picks ``tokens[i]``:
    one serving prefill of the prompt and ``tokens[:i]`` (K/V round
    tripped through the int8 pool grid, as the engine's prefill does).
    Returns (margin, top-1 logit, top-1 token, top-2 token)."""
    from repro_torch.attention import AttnSpec
    from repro_torch.models import registry
    seq = list(prompt) + list(tokens[:i])
    cache = registry.init_cache(cfg, 1, len(seq), device="cuda")
    logits, _, _ = registry.apply_prefill(
        cfg, params, {"tokens": torch.tensor([seq], device="cuda")}, cache,
        attn=AttnSpec(kv_dtype="int8"))
    top = torch.topk(logits[0, -1].float(), 2)
    return ((top.values[0] - top.values[1]).item(), top.values[0].item(),
            int(top.indices[0]), int(top.indices[1]))


def phase_stream(torch, cfg, params):
    """qwen2-1.5b at full width on phase 5's weights, graphed at horizon
    4: (a) 24 requests through the stream scheduler and the static engine,
    equal tokens, the FUM kernel's runs on the card equal the engine's
    count; (b) a 2,500-token prompt prefilled in slices interleaved with
    8 short requests' decode, equal to the static engine's blocking
    chunked prefill; (c) preemption of low-priority requests for two
    high-priority arrivals, head gate off, graphed equal to eager, against
    the uninterrupted static run (and with HDP off, every request equal);
    (d) reduced granite-8b with everything on (HDP, horizon 4, prefix
    cache, spec decode, the scheduler), card vs CPU; (e) approx_softmax:
    the reduced config card vs CPU, and one full-width serving prefill
    with and without it. Returns the FUM runs of (a)'s stream serve."""
    import numpy as np
    from repro_torch.attention import AttnSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import Engine, Request, SchedulerConfig
    out = {}
    kw = dict(SERVE_KW, decode_horizon=4)

    # ---- (a) stream equals static, 24 requests through 8 slots, in
    # turns (static, stream, stream, static) so their times compare
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=STREAM_REQUESTS)]
    reqs = lambda: [Request(u, p, max_new_tokens=32)
                    for u, p in enumerate(prompts)]
    label = "stream, 24 requests, graphed, horizon 4"
    st_tok, timings = None, {"static": [], "stream": []}
    for turn in ("static", "stream", "stream", "static"):
        eng = Engine(cfg, params, device="cuda",
                     stream_sched=turn == "stream", **kw)
        tok, res, s, wall, launches, runs = serve_requests(torch, eng, reqs())
        del eng
        timings[turn].append(dict(
            {k: s.get(k) for k in (
                "ttft_s_p50", "ttft_s_p95", "ttft_s_mean", "tpot_s_mean",
                "queue_wait_s_mean", "queue_depth_mean", "queue_depth_peak",
                "decode_tok_s", "decode_tok_s_steady", "prefill_s",
                "sched_tick_s", "sched_ticks")}, wall_s=wall))
        log_sched(f"{turn}, 24 requests, graphed, horizon 4 (turn "
                  f"{len(timings[turn])})", s)
        log(f"[sched] {turn}: wall {wall:.3f} s, decode_tok_s "
            f"{s['decode_tok_s']:.1f} (without the capture "
            f"{s['decode_tok_s_steady']:.1f}), prefill_s "
            f"{s['prefill_s']:.3f}")
        if st_tok is None:
            st_tok = tok
            continue
        bad = first_divergence(tok, st_tok)
        check(not bad, f"{label}: {turn} tokens differ from the static "
              f"engine's (uid: first index, {turn}, static): {bad}")
        if turn != "stream":
            continue
        check(s["sched_admitted"] == STREAM_REQUESTS
              and s["sched_recycled"] > 0,
              f"{label}: admitted {s['sched_admitted']}, recycled "
              f"{s['sched_recycled']}")
        check(s["graph_captures"] == 1, f"{label}: {s['graph_captures']} "
              "graph captures, expected 1")
        check_decode_launches(s, launches, "fum", label, runs)
        check(all(r.ttft_s > 0 and r.queue_wait_s >= 0 and r.tpot_s > 0
                  for r in res.values()),
              f"{label}: request timings missing or negative")
        log_served(label, s, wall)
        out["fum_runs"] = runs["fum"]
    log(f"[sched] {label}: tokens == the static engine's for all "
        f"{STREAM_REQUESTS} requests, in both turns")
    out["timings"] = timings

    # ---- (b) a long prompt prefilled in slices under live decode
    lkw = dict(kw, max_len=LONG_MAX_LEN)
    rng = np.random.default_rng(22)
    long_p = rng.integers(1, cfg.vocab_size, size=LONG_PROMPTS[0]).tolist()
    shorts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
              for n in rng.integers(200, 1001, size=8)]
    breqs = lambda: [Request(u, p, max_new_tokens=32)
                     for u, p in enumerate([long_p] + shorts)]
    static = Engine(cfg, params, device="cuda", **lkw)
    st_tok, st_res = serve_requests(torch, static, breqs())[:2]
    del static
    eng = Engine(cfg, params, device="cuda",
                 sched=SchedulerConfig(prefill_chunk_tokens=512), **lkw)
    tok, res, s, wall, launches, runs = serve_requests(torch, eng, breqs())
    label = "stream, a 2,500-token prompt among 8 short ones"
    check(s["stream_sched"], f"{label}: a sched config did not turn the "
          "scheduler on")
    check(s["sched_interleaved_steps"] > 0
          and s["sched_chunk_tokens"] >= LONG_PROMPTS[0],
          f"{label}: interleaved steps {s['sched_interleaved_steps']}, chunk "
          f"tokens {s['sched_chunk_tokens']}")
    bad = first_divergence(tok, st_tok)
    check(not bad, f"{label}: tokens differ from the static engine's "
          f"blocking chunked prefill: {bad}")
    check_decode_launches(s, launches, "fum", label, runs)
    log_served(label, s, wall)
    log_sched(label, s)
    short_ttft = {name: float(np.mean([r[u].ttft_s for u in range(1, 9)]))
                  for name, r in (("stream", res), ("static", st_res))}
    log(f"[sched] {label}: tokens == the static engine's (one blocking "
        f"chunked prefill); the 8 short requests' mean TTFT "
        f"{short_ttft['stream']:.4f} s (static {short_ttft['static']:.4f} "
        f"s), the long one's {res[0].ttft_s:.4f} s (static "
        f"{st_res[0].ttft_s:.4f} s)")
    out["interleaved"] = {"short_ttft_mean": short_ttft,
                          "long_ttft": {"stream": res[0].ttft_s,
                                        "static": st_res[0].ttft_s},
                          "interleaved_steps": s["sched_interleaved_steps"]}
    del eng

    # ---- (c) preemption: two high-priority arrivals, head gate off
    nogate = cfg.replace(hdp=cfg.hdp.replace(head_pruning=False))
    rng = np.random.default_rng(23)
    cprompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
                for n in rng.integers(200, 901, size=10)]
    low = lambda: [Request(u, p, max_new_tokens=PREEMPT_NEW)
                   for u, p in enumerate(cprompts[:8])]
    high = lambda: [Request(u, p, max_new_tokens=32, priority=1)
                    for u, p in enumerate(cprompts[8:], start=8)]
    for hdp_on in (True, False):
        c = nogate if hdp_on else cfg.replace(
            hdp=cfg.hdp.replace(enabled=False))
        tag = "HDP on, head gate off" if hdp_on else "HDP off"
        static = Engine(c, params, device="cuda", **kw)
        ref = serve_requests(torch, static, low() + high())[0]
        del static
        runs_c, cut = {}, {}
        for graphed in (True, False):
            eng = Engine(c, params, device="cuda", cuda_graph=graphed,
                         sched=SchedulerConfig(preempt_after=2), **kw)
            preempt = eng._preempt

            def recording(slot, _preempt=preempt, _cut=cut):
                # tokens a victim had generated when it was preempted
                resume = _preempt(slot)
                _cut[resume.uid] = len(resume.prior_tokens)
                return resume

            eng._preempt = recording
            runs_c[graphed] = serve_requests(
                torch, eng, low(), arrive_after=PREEMPT_AFTER_STEPS,
                late=high())
            del eng._preempt   # the closure holds the engine: free it
            eng.pages.allocator.assert_drained()
            del eng
        tok, res, s = runs_c[True][:3]
        label = f"preemption ({tag})"
        check(tok == runs_c[False][0], f"{label}: graphed tokens differ from "
              f"the eager run's: {first_divergence(tok, runs_c[False][0])}")
        check(s["sched_preempted"] >= 1, f"{label}: nothing was preempted")
        victims = sorted(u for u, r in res.items() if r.preemptions)
        check(victims and all(u < 8 for u in victims),
              f"{label}: preempted {victims}")
        bad = first_divergence(tok, ref)
        kept = {u: v for u, v in bad.items() if u not in victims}
        check(not kept, f"{label}: requests never preempted differ from the "
              f"uninterrupted static run: {kept}")
        early = {u: bad[u] for u in victims if u in bad and bad[u][0] < cut[u]}
        check(not early, f"{label}: victims differ from the uninterrupted "
              f"run before their preemption ({cut}): {early}")
        log_sched(label, s)
        log(f"[sched] {label}: graphed == eager; {s['sched_preempted']} "
            f"preemption(s), victims {victims} after {cut} tokens; the "
            "other requests == the uninterrupted static run, the victims up "
            "to their preemption; pool drained")
        margins = {}
        for u in victims:
            if u not in bad:
                log(f"[sched] {label}: victim {u} == the uninterrupted run")
                continue
            # the resume re-prefills the generated tokens: in bf16 that
            # rounds apart from the decode steps that made them (and with
            # HDP on its scout prunes by block tiles, not per step), so a
            # victim may part from the uninterrupted run at a near-tie, in
            # the reference too (ROADMAP.md section 3)
            i, a, b = bad[u]
            margin, top1, t1, t2 = top2_margin(torch, c, params, cprompts[u],
                                               ref[u], i)
            ulps = margin / bf16_ulp(top1)
            margins[u] = (i, margin, ulps)
            log(f"[sched] {label}: victim {u} parts from the uninterrupted "
                f"run at token {i} ({a} vs {b}), {i - cut[u]} after its "
                f"resume; top-2 logit margin there {margin:.4e} = {ulps:.1f} "
                f"bf16 ulps of the top logit {top1:.4f} (tokens {t1}, {t2})")
            if not hdp_on:
                check(ulps <= 4, f"{label}: victim {u} parts at a top-2 "
                      f"margin of {ulps:.1f} bf16 ulps, not a near-tie")
        out[f"preempt_{'hdp' if hdp_on else 'dense'}"] = {
            "victims": victims, "cut": cut, "diverged": margins}

    # ---- (d) reduced granite-8b, everything on: card vs CPU
    small = reduced(get_config("granite-8b"))
    dkw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
               decode_horizon=4, prefix_cache=True, spec_decode=True,
               stream_sched=True)
    gpu = Engine(small, device="cuda", seed=5, **dkw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **dkw)
    prng = np.random.default_rng(24)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(5)] + [prng.integers(1, 250, size=40).tolist()]
    toks, sums = [], []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
        sums.append(e.summary())
    check(toks[0] == toks[1], f"reduced granite-8b, everything on: card "
          f"tokens {toks[0]} != CPU tokens {toks[1]}")
    check(sums[0]["sched_recycled"] == sums[1]["sched_recycled"] > 0
          and sums[0]["spec_graphs"] > 0,
          f"reduced granite-8b, everything on: recycled "
          f"{sums[0]['sched_recycled']}/{sums[1]['sched_recycled']}, spec "
          f"graphs {sums[0]['spec_graphs']}")
    log(f"[sched] reduced granite-8b, HDP + horizon 4 + prefix cache + spec "
        f"decode + stream scheduler (one prompt chunked): card tokens "
        f"(graphed) == CPU tokens; recycled {sums[0]['sched_recycled']}, "
        f"hits {sums[0]['prefix_hits']}, acceptance "
        f"{sums[0]['acceptance_rate']:.4f}")
    del gpu, cpu

    # ---- (e) approx_softmax: reduced card vs CPU, full-width prefill
    small = reduced(cfg)
    small = small.replace(hdp=small.hdp.replace(approx_softmax=True))
    ekw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
               decode_horizon=4)
    gpu = Engine(small, device="cuda", seed=6, **ekw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **ekw)
    toks = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
    backends = {p: gpu.resolved_backend(p) for p in ("prefill", "decode")}
    check(toks[0] == toks[1], f"reduced qwen2-1.5b, approx_softmax: card "
          f"tokens {toks[0]} != CPU tokens {toks[1]}")
    check(backends == {"prefill": "xla_hdp", "decode": "paged_hdp_decode"},
          f"approx_softmax resolved to {backends}")
    log(f"[approx] reduced qwen2-1.5b, approx_softmax: card tokens (graphed) "
        f"== CPU tokens; backends {backends}, decode stage 3 "
        f"{gpu.summary()['attn_decode_stage3']}")
    del gpu, cpu
    from repro_torch.models import registry
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        1, cfg.vocab_size, (1, 1024))).cuda()
    last, secs = {}, {}
    spec = AttnSpec(kv_dtype="int8")
    for approx in (False, True):
        c = cfg.replace(hdp=cfg.hdp.replace(approx_softmax=approx,
                                            calib="none"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = registry.apply_prefill(
            c, params, {"tokens": toks},
            registry.init_cache(c, 1, 1024, device="cuda"), attn=spec)
        torch.cuda.synchronize()
        secs[approx] = time.perf_counter() - t0
        last[approx] = logits[0, -1].float()
    delta = (last[True] - last[False]).abs().max().item()
    check(bool(torch.isfinite(last[True]).all()) and np.isfinite(delta),
          f"full-width approx_softmax prefill: logits finite "
          f"{bool(torch.isfinite(last[True]).all())}, max |delta| {delta}")
    log(f"[approx] qwen2-1.5b full width, one serving prefill of 1,024 "
        f"tokens (xla_hdp): max |last-position logits, approx_softmax - "
        f"exact| {delta:.4e} (max |logit| "
        f"{last[False].abs().max().item():.3e}); prefill {secs[True]:.3f} s "
        f"with, {secs[False]:.3f} s without")
    out["approx"] = {"max_abs_delta": delta, "prefill_s": secs[True],
                     "prefill_s_exact": secs[False]}
    return out


# ------------------- phase 5g: fault injection, deadlines, ReplicaSet
#: phase 5g's fault plans: the engine step (or fleet step, for kill) of
#: each event, and the requests they target
NAN_STEP, NAN_UID = 2, 3
ERR_STEP = 3
KILL_STEP = 3
#: (d): the deadline (s) of the request that expires while decoding
DEADLINE_S, DEADLINE_UID = 0.25, 5
#: (e): the speculative serve's plan
SPEC_PLAN = "nan@2:uid=4;error@4"
#: (g): test_chaos_identity_acceptance's plan (tests/test_faults.py)
CHAOS_PLAN = "slow@0:s=0.005;exhaust@2;nan@1:uid=3;kill@3:replica=0"


def static_buffers(eng):
    """Every static buffer the decode step or round reads or writes
    (clones), and the pool tensors' addresses."""
    bufs = {n: getattr(eng, n).clone() for n in
            ("_tok", "_pos", "_act", "_rem", "_eos", "_floor", "_inject",
             "_t", "_hist")}
    bufs["table"] = eng.pages.table().clone()
    return bufs, {k: v.data_ptr() for k, v in eng.pages.cache.items()}


def check_fleet_runs(rs, runs, label):
    """Each replica counts 28 FUM launches per decode step it ran, and
    each captured graph ran one warm-up step: the kernel's count on the
    card over the fleet's serve is their sum. With HDP off the decode
    (``xla_dense``) runs no kernel, and every count is 0."""
    on = rs.engines[0].resolved_backend("decode") == "pallas_paged_decode"
    per = N_LAYERS_QWEN if on else 0
    steps = sum(e.metrics["decode_steps"] for e in rs.engines)
    caps = sum(e.metrics["graph_captures"] for e in rs.engines)
    n = sum(e.metrics["fum_kernel_launches"] for e in rs.engines)
    check(n == per * steps and steps > 0
          and runs["fum"] == per * (steps + caps) and runs["block"] == 0,
          f"{label}: {runs} kernel runs on the card, the replicas counted "
          f"{n} FUM launches over {steps} decode steps and {caps} "
          f"captures; expected {per} a step")
    log(f"[faults] {label}: {runs['fum']} runs of the fum kernel on the "
        f"card = {per} layers x ({steps} decode steps + {caps} warm-up "
        "steps) over the replicas")
    return runs["fum"]


def check_moved(torch, cfg, params, label, got, ref, prompts, moved, cut,
                assert_tie):
    """Requests never moved equal the uninterrupted run; a moved one
    equals it up to its failover (``cut`` tokens) and may part after its
    recompute resume only at a near-tie (asserted with ``assert_tie``,
    printed either way). Returns {uid: (index, margin, ulps)}."""
    bad = first_divergence(got, ref)
    kept = {u: v for u, v in bad.items() if u not in moved}
    check(not kept, f"{label}: requests never moved differ from the "
          f"uninterrupted run: {kept}")
    early = {u: bad[u] for u in moved if u in bad and bad[u][0] < cut[u]}
    check(not early, f"{label}: moved requests differ from the "
          f"uninterrupted run before their failover ({cut}): {early}")
    margins = {}
    for u in sorted(moved):
        if u not in bad:
            log(f"[faults] {label}: moved request {u} (after {cut[u]} "
                "tokens) == the uninterrupted run")
            continue
        i, a, b = bad[u]
        margin, top1, t1, t2 = top2_margin(torch, cfg, params, prompts[u],
                                           ref[u], i)
        ulps = margin / bf16_ulp(top1)
        margins[u] = (i, margin, ulps)
        log(f"[faults] {label}: moved request {u} parts from the "
            f"uninterrupted run at token {i} ({a} vs {b}), {i - cut[u]} "
            f"after its failover; top-2 logit margin there {margin:.4e} = "
            f"{ulps:.1f} bf16 ulps of the top logit {top1:.4f} (tokens "
            f"{t1}, {t2})")
        if assert_tie:
            check(ulps <= 4, f"{label}: moved request {u} parts at a top-2 "
                  f"margin of {ulps:.1f} bf16 ulps, not a near-tie")
    return margins


def kill_serve(torch, cfg, params, prompts, label):
    """Phase 5's traffic through two graphed replicas with replica 0
    killed at fleet step ``KILL_STEP``. Returns (tokens, the moved uids,
    the tokens each had made at the kill, FUM runs on the card)."""
    from repro_torch.serving import ReplicaSet, Request
    rs = ReplicaSet.build(cfg, 2, params=params, device="cuda",
                          faults=f"kill@{KILL_STEP}:replica=0",
                          decode_horizon=4, **SERVE_KW)
    zero_launches()
    for u, p in enumerate(prompts):
        rs.submit(Request(u, p, max_new_tokens=32))
    for _ in range(KILL_STEP):
        rs.step()
    made = {st["req"].uid: len(st["generated"])
            for st in rs.engines[0]._active.values()}
    res = rs.run()
    _, runs = kernel_counts(torch)
    s = rs.summary()
    moved = set(rs._failed_over)
    cut = {u: made.get(u, 0) for u in moved}
    check(s["health"] == ["dead", "up"] and s["failovers"] == 1
          and s["requests_failed_over"] == len(moved) > 0
          and not rs.faults.pending,
          f"{label}: health {s['health']}, failovers {s['failovers']}, "
          f"moved {sorted(moved)}")
    check(sorted(res) == list(range(len(prompts)))
          and sorted(rs._finish_log) == list(range(len(prompts)))
          and all(r.complete and r.status == "ok" for r in res.values()),
          f"{label}: not every uid finished exactly once: finish log "
          f"{rs._finish_log}, {[(u, r.status) for u, r in res.items()]}")
    rs.engines[1].pages.allocator.assert_drained()
    fum = check_fleet_runs(rs, runs, label)
    log(f"[faults] {label}: health {s['health']}, {len(moved)} requests "
        f"moved ({ {u: cut[u] for u in sorted(moved)} } tokens made "
        f"before), each uid finished once, the survivor's allocator "
        f"drained; requests_per_replica {s['requests_per_replica']}")
    return {u: r.tokens for u, r in res.items()}, moved, cut, fum


def phase_faults(torch, cfg, params, h1_tokens):
    """qwen2-1.5b at full width on phase 5's weights and traffic, graphed
    at horizon 4: (0) fault-free, equal to phase 5's tokens; (a) a NaN
    injected into one request's logits; (b) an injected step error, then
    a second run; (c) an injected pool exhaustion under the stream
    scheduler; (d) a deadline that expires while decoding and a queue
    wait that expires while queued; (e) speculative decode at draft_len
    4 with a NaN and a step error; (f) two replicas without faults and
    with replica 0 killed (HDP on, and HDP off where a moved request's
    parting is asserted to be a near-tie); (g) the reduced config in fp32,
    HDP off, on the reference's chaos plan and traffic, card vs CPU.
    Returns the FUM runs on the card by serve, the sub-phases' wall
    seconds and what they measured."""
    import numpy as np
    from repro_torch.configs import reduced
    from repro_torch.serving import (Engine, InjectedFault, ReplicaSet,
                                     Request, SchedulerConfig)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    kw = dict(SERVE_KW, decode_horizon=4)
    reqs = lambda: [Request(u, p, max_new_tokens=32)
                    for u, p in enumerate(prompts)]
    out, secs, fum = {}, {}, {}

    def sub(name, t0):
        secs[name] = round(time.perf_counter() - t0, 2)
        log(f"[faults] ({name}) wall {secs[name]:.2f} s")

    # ---- (0) fault-free: the decode step now reads the NaN mask
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda", **kw)
    tok, _, s, wall, launches, runs = serve_requests(torch, eng, reqs())
    del eng
    check(tok == h1_tokens, "fault-free: tokens differ from phase 5's: "
          f"{first_divergence(tok, h1_tokens)}")
    check_decode_launches(s, launches, "fum", "5g fault-free", runs)
    fum["qwen2-1.5b 5g (0) fault-free, graphed, horizon 4"] = runs["fum"]
    one_tok_s = (s["decode_tok_s"], s["decode_tok_s_steady"])
    out["fault_free"] = {"decode_tok_s": s["decode_tok_s"],
                         "decode_tok_s_steady": s["decode_tok_s_steady"],
                         "wall_s": wall}
    log_served("5g fault-free, graphed, horizon 4 (reads the NaN mask)",
               s, wall)
    sub("0", t0)

    # ---- (a) nan@S:uid=U
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda",
                 faults=f"nan@{NAN_STEP}:uid={NAN_UID}", **kw)
    tok, res, s, wall, launches, runs = serve_requests(
        torch, eng, reqs(), faulted=(NAN_UID,))
    label = f"nan@{NAN_STEP}:uid={NAN_UID}"
    r = res[NAN_UID]
    check(r.status == "error" and not r.complete
          and "non-finite" in (r.error or ""),
          f"{label}: uid {NAN_UID} came back {r.status} ({r.error})")
    bad = first_divergence({u: t for u, t in tok.items() if u != NAN_UID},
                           h1_tokens)
    check(not bad, f"{label}: untargeted requests differ from phase 5's: "
          f"{bad}")
    check(s["faults_injected"] == 1 and s["req_errors"] == 1
          and s["graph_captures"] == 1 and not eng._inject.any(),
          f"{label}: faults_injected {s['faults_injected']}, req_errors "
          f"{s['req_errors']}, graph_captures {s['graph_captures']}")
    eng.pages.allocator.assert_drained()
    check_decode_launches(s, launches, "fum", label, runs)
    del eng
    fum[f"qwen2-1.5b 5g (a) {label}, graphed, horizon 4"] = runs["fum"]
    log(f"[faults] (a) {label}: uid {NAN_UID} error after "
        f"{len(tok[NAN_UID])} tokens ({r.error}); the 7 others == phase "
        f"5's tokens; faults_injected 1, one graph capture, pool drained; "
        f"decode_tok_s {s['decode_tok_s']:.1f}")
    sub("a", t0)

    # ---- (b) error@S: raised out of run(); a second run() completes
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda", faults=f"error@{ERR_STEP}",
                 **kw)
    label = f"error@{ERR_STEP}"
    zero_launches()
    for rq in reqs():
        eng.submit(rq)
    for _ in range(ERR_STEP):
        eng.step()
    before, ptrs = static_buffers(eng)
    caps = eng.metrics["graph_captures"]
    try:
        eng.run()
        raised = False
    except InjectedFault:
        raised = True
    check(raised, f"{label}: run() did not raise InjectedFault")
    after, ptrs_after = static_buffers(eng)
    changed = [n for n in before if not torch.equal(before[n], after[n])]
    check(not changed and ptrs_after == ptrs
          and eng.metrics["graph_captures"] == caps == 1,
          f"{label}: the failed step left {changed} changed, pool "
          f"addresses equal {ptrs_after == ptrs}, captures "
          f"{eng.metrics['graph_captures']}")
    res = eng.run(strict=True)
    launches, runs = kernel_counts(torch)
    s = eng.summary()
    tok = {u: r.tokens for u, r in res.items()}
    check(tok == h1_tokens and all(r.complete for r in res.values()),
          f"{label}: the second run's tokens differ from phase 5's: "
          f"{first_divergence(tok, h1_tokens)}")
    check({k: v.data_ptr() for k, v in eng.pages.cache.items()} == ptrs
          and s["graph_captures"] == 1,
          f"{label}: pool moved or graph re-captured "
          f"({s['graph_captures']} captures)")
    eng.pages.allocator.assert_drained()
    check_decode_launches(s, launches, "fum", label, runs)
    del eng
    fum[f"qwen2-1.5b 5g (b) {label}, graphed, horizon 4"] = runs["fum"]
    log(f"[faults] (b) {label}: InjectedFault out of run() at step "
        f"{ERR_STEP}; every static buffer (slot state, history, step "
        f"index, table rows, write floors, NaN mask) as the step found "
        f"it, pool addresses and the one capture unchanged; the second "
        f"run() == phase 5's tokens")
    sub("b", t0)

    # ---- (c) exhaust@0 under the stream scheduler
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda", stream_sched=True,
                 faults="exhaust@0", **kw)
    tok, res, s, wall, launches, runs = serve_requests(torch, eng, reqs())
    label = "exhaust@0, stream scheduler"
    check(tok == h1_tokens, f"{label}: tokens differ from phase 5's: "
          f"{first_divergence(tok, h1_tokens)}")
    check(s["sched_deferred"] >= 1 and s["faults_injected"] == 1
          and s["graph_captures"] == 1,
          f"{label}: sched_deferred {s['sched_deferred']}, faults_injected "
          f"{s['faults_injected']}, captures {s['graph_captures']}")
    eng.pages.allocator.assert_drained()
    check_decode_launches(s, launches, "fum", label, runs)
    del eng
    fum[f"qwen2-1.5b 5g (c) {label}, graphed, horizon 4"] = runs["fum"]
    log(f"[faults] (c) {label}: sched_deferred {s['sched_deferred']}, "
        "tokens == phase 5's")
    sub("c", t0)

    # ---- (d) deadlines: one expires while decoding, one while queued
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda", **kw)
    label = "deadlines"
    zero_launches()
    extra = rng.integers(1, cfg.vocab_size, size=300).tolist()
    t_sub = time.perf_counter()
    for rq in reqs():
        eng.submit(rq, deadline_s=DEADLINE_S if rq.uid == DEADLINE_UID
                   else None)
    eng.submit(Request(8, extra, max_new_tokens=32), max_queue_wait_s=0.0)
    eng.step()              # the queued one expires; the 8 decode
    check(len(eng._active) == 8, f"{label}: {len(eng._active)} active")
    time.sleep(max(0.0, DEADLINE_S - (time.perf_counter() - t_sub)) + 0.01)
    res = eng.run(strict=True)
    launches, runs = kernel_counts(torch)
    s = eng.summary()
    r, q = res[DEADLINE_UID], res[8]
    check(r.status == q.status == "deadline" and not r.complete
          and "deadline_s" in r.error and "max_queue_wait_s" in q.error
          and q.tokens == [] and s["req_deadline"] == 2,
          f"{label}: uid {DEADLINE_UID} {r.status} ({r.error}), uid 8 "
          f"{q.status} ({q.error}), req_deadline {s['req_deadline']}")
    check(r.tokens == h1_tokens[DEADLINE_UID][:len(r.tokens)]
          and len(r.tokens) == 4,
          f"{label}: uid {DEADLINE_UID}'s {len(r.tokens)} tokens")
    bad = first_divergence({u: res[u].tokens for u in range(8)
                            if u != DEADLINE_UID}, h1_tokens)
    check(not bad, f"{label}: the other requests differ from phase 5's: "
          f"{bad}")
    check(s["graph_captures"] == 1 and not eng._deadlines,
          f"{label}: captures {s['graph_captures']}, deadlines left "
          f"{eng._deadlines}")
    eng.pages.allocator.assert_drained()
    check_decode_launches(s, launches, "fum", label, runs)
    del eng
    fum[f"qwen2-1.5b 5g (d) {label}, graphed, horizon 4"] = runs["fum"]
    log(f"[faults] (d) {label}: uid {DEADLINE_UID} (deadline_s "
        f"{DEADLINE_S}) cancelled while decoding after {len(r.tokens)} "
        f"tokens ({r.error}); uid 8 (max_queue_wait_s 0) cancelled while "
        f"queued; the 7 others == phase 5's tokens")
    sub("d", t0)

    # ---- (e) speculative decode, draft_len 4, with nan@ and error@
    t0 = time.perf_counter()
    eng = Engine(cfg, params, device="cuda", spec_decode=True, draft_len=4,
                 faults=SPEC_PLAN, **SERVE_KW)
    label = f"spec decode, draft_len 4, {SPEC_PLAN}"
    zero_launches()
    for rq in reqs():
        eng.submit(rq)
    try:
        eng.run()
        raised = False
    except InjectedFault:
        raised = True
    check(raised, f"{label}: run() did not raise InjectedFault")
    caps = eng.metrics["graph_captures"]
    res = eng.run()
    launches, runs = kernel_counts(torch)
    s = eng.summary()
    spec_uid = int(SPEC_PLAN.split("uid=")[1].split(";")[0])
    r = res[spec_uid]
    check(r.status == "error" and "non-finite" in (r.error or ""),
          f"{label}: uid {spec_uid} came back {r.status} ({r.error})")
    bad = first_divergence({u: res[u].tokens for u in range(8)
                            if u != spec_uid}, h1_tokens)
    check(not bad and all(res[u].complete for u in range(8)
                          if u != spec_uid),
          f"{label}: untargeted requests differ from phase 5's: {bad}")
    check(s["faults_injected"] == 1 and s["accepted_tokens"] >= 0
          and s["graph_captures"] == caps == s["spec_graphs"],
          f"{label}: faults_injected {s['faults_injected']}, accepted "
          f"{s['accepted_tokens']}, captures {s['graph_captures']} "
          f"(before the second run {caps})")
    eng.pages.allocator.assert_drained()
    want = _check_spec_runs(s, runs, N_LAYERS_QWEN, label, graphed=True)
    del eng
    fum[f"qwen2-1.5b 5g (e) {label}"] = runs["fum"]
    log(f"[faults] (e) {label}: InjectedFault out of the first run(); "
        f"uid {spec_uid} error ({r.error}); the others == phase 5's tokens "
        f"after the second run; {runs['fum']} FUM runs on the card = "
        f"{want} ({N_LAYERS_QWEN} x ({s['spec_rounds']} verifies + "
        f"{s['graph_captures']} warm-up rounds)); accepted_tokens "
        f"{s['accepted_tokens']}, captures {s['graph_captures']}")
    sub("e", t0)

    # ---- (f) ReplicaSet: two replicas sharing the weights
    t0 = time.perf_counter()
    rs = ReplicaSet.build(cfg, 2, params=params, device="cuda", **kw)
    label = "ReplicaSet dp 2, no faults"
    ptr = [e.params["embed"]["tok"].data_ptr() for e in rs.engines]
    check(ptr[0] == ptr[1] and rs.engines[0].params is rs.engines[1].params,
          f"{label}: the replicas' embedding tables at {ptr}")
    zero_launches()
    for rq in reqs():
        rs.submit(rq)
    res = rs.run()
    _, runs = kernel_counts(torch)
    s = rs.summary()
    tok = {u: r.tokens for u, r in res.items()}
    check(tok == h1_tokens, f"{label}: tokens differ from the single "
          f"engine's: {first_divergence(tok, h1_tokens)}")
    fum[f"qwen2-1.5b 5g (f) {label}, graphed, horizon 4"] = \
        check_fleet_runs(rs, runs, label)
    steady = s["tokens_out"] / (s["decode_s"] - sum(
        e.metrics["graph_capture_s"] for e in rs.engines))
    out["fleet"] = {"decode_tok_s": s["decode_tok_s"],
                    "decode_tok_s_steady": steady,
                    "one_engine": one_tok_s,
                    "requests_per_replica": s["requests_per_replica"]}
    log(f"[faults] (f) {label}: tokens == the single graphed engine's; "
        f"shared params (embedding at {ptr[0]:#x} in both); "
        f"requests_per_replica {s['requests_per_replica']}; fleet "
        f"decode_tok_s {s['decode_tok_s']:.1f}, without the 2 captures "
        f"{steady:.1f} (the replicas step in turn on the one card), one "
        f"engine's {one_tok_s[0]:.1f}, without its capture "
        f"{one_tok_s[1]:.1f}")
    del rs
    for hdp_on in (True, False):
        c = cfg if hdp_on else cfg.replace(
            hdp=cfg.hdp.replace(enabled=False))
        tag = "HDP on" if hdp_on else "HDP off"
        if hdp_on:
            ref = h1_tokens
        else:
            ref = serve_requests(torch, Engine(c, params, device="cuda",
                                               **kw), reqs())[0]
        label = f"ReplicaSet dp 2, kill@{KILL_STEP}:replica=0, {tag}"
        tok, moved, cut, runs_k = kill_serve(torch, c, params, prompts,
                                             label)
        if hdp_on:    # HDP off decodes through xla_dense, no kernel
            fum[f"qwen2-1.5b 5g (f) {label}, graphed, horizon 4"] = runs_k
        out[f"kill_{'hdp' if hdp_on else 'dense'}"] = {
            "moved": sorted(moved), "cut": cut,
            "diverged": check_moved(torch, c, params, label, tok, ref,
                                    prompts, moved, cut,
                                    assert_tie=not hdp_on)}
    sub("f", t0)

    # ---- (g) the reduced config, fp32, HDP off: the chaos plan, card
    # vs CPU
    t0 = time.perf_counter()
    small = reduced(cfg)
    small = small.replace(hdp=small.hdp.replace(enabled=False))
    gkw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
               stream_sched=True,
               sched=SchedulerConfig(preempt_after=2, watchdog_steps=80))
    gpu = ReplicaSet.build(small, 2, seed=8, device="cuda",
                           faults=CHAOS_PLAN, **gkw)
    cpu = ReplicaSet.build(small, 2, params={
        k: _tree_to(v, "cpu") for k, v in gpu.engines[0].params.items()},
        device="cpu", faults=CHAOS_PLAN, **gkw)
    prng = np.random.default_rng(32)
    cp = [prng.integers(1, 250, size=int(prng.integers(10, 20))).tolist()
          for _ in range(7)]
    got = []
    for rs in (gpu, cpu):
        for uid in range(6):
            rs.submit(Request(uid, cp[uid], max_new_tokens=12))
        for _ in range(5):
            rs.step()
        rs.submit(Request(6, cp[6], max_new_tokens=4, priority=1))
        res = rs.run(max_steps=400)
        s = rs.summary()
        got.append((
            {u: (r.tokens, r.status, r.complete, r.preemptions)
             for u, r in sorted(res.items())},
            {u: rs.engines.index(e) for u, e in rs._home.items()},
            {k: s[k] for k in ("health", "failovers", "requests_failed_over",
                               "requests_per_replica", "faults_fired",
                               "tokens_out")},
            [{k: e.metrics[k] for k in (
                "faults_injected", "req_errors", "sched_preempted",
                "sched_deferred", "sched_admitted", "decode_steps",
                "tokens_out", "prefill_calls")} for e in rs.engines]))
    label = "reduced qwen2-1.5b fp32, HDP off, the chaos plan"
    check(got[0] == got[1], f"{label}: card {got[0]} != CPU {got[1]}")
    res, _, s, m = got[0]
    check(res[3][1] == "error" and s["failovers"] == 1
          and sum(x["sched_preempted"] for x in m) >= 1
          and not gpu.faults.pending
          and gpu.engines[0].metrics["graph_captures"] >= 1,
          f"{label}: uid 3 {res[3][1]}, failovers {s['failovers']}, "
          f"preempted {[x['sched_preempted'] for x in m]}")
    log(f"[faults] (g) {label} ({CHAOS_PLAN}): card (graphed) == CPU on "
        f"every token, status and counter; {s}, {m}")
    del gpu, cpu
    sub("g", t0)
    out["secs"] = secs
    out["fum_runs"] = fum
    return out


# ---------- phase 5h: hardware profile, cost policy, adaptive speculation
#: the forced plan of phase 5h (d): the reference test's thrashing
#: schedule of round widths (k 1 conservative, 2 base, 3-4 aggressive)
FORCED_PLAN = (4, 1, 2, 4, 1, 3, 2, 1, 4, 2)
#: timed runs per probed candidate in phase 5h (b) (the tuner's default
#: is 3): an eager probe of a decode route times mostly the host's
#: dispatch of the plain stages 1-2 both routes share, and the minimum
#: of 3 runs let the block route win one of three runs of this phase;
#: the minimum of 20, and of 50, still let it win where the tuner timed
#: each candidate's runs in one block and the host's speed drifted
#: between the blocks; it now times the candidates in turn, rep by rep
#: (``Tuner._probe``)
PROBE_REPS = 50
#: the profile's peaks may be exceeded by a measurement by this factor
#: at most; a higher reading means the yardstick is wrong
PEAK_SLACK = 1.05


class ForcedPlan:
    """A SpecController stand-in replaying ``FORCED_PLAN`` (then k = 1),
    each width with its fixed tier; the real controller folds each
    round's acceptance in and keeps the summary."""

    def __init__(self, ctl):
        self.ctl, self.ks, self.plans = ctl, list(FORCED_PLAN), []

    def plan(self):
        k = self.ks.pop(0) if self.ks else 1
        tier = {1: self.ctl.conservative, 2: self.ctl.base}
        self.plans.append(k)
        return k, tier.get(k, self.ctl.aggressive)

    def update(self, accepted, drafted):
        self.ctl.update(accepted, drafted)

    def summary(self):
        return self.ctl.summary()


def count_rounds(torch, eng):
    """Wrap ``eng._run`` so that the FUM kernel's count on the card is
    copied on the stream (no wait for the card) before and after each
    graph run: returns the list of (key, before, after) it fills; undo
    with ``del eng._run``."""
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    counter = hdp_paged_fum_decode.runs.tensor("cuda")
    rounds = []
    run_once = eng._run

    def marking(key, body, width):
        before = counter.clone()
        run_once(key, body, width)
        rounds.append((key, before, counter.clone()))

    eng._run = marking
    return rounds


def check_round_runs(s, rounds, runs, label):
    """Each (k, tier) of a graphed speculative serve is captured once, and
    the FUM kernel's runs on the card in the rounds of each key are 28 x
    (its rounds + 1 warm-up). Returns the runs by key."""
    keys = [k for k, _, _ in rounds]
    per_key = Counter()
    for k, before, after in rounds:
        per_key[k] += int((after - before).item())
    want = {k: N_LAYERS_QWEN * (keys.count(k) + 1) for k in set(keys)}
    check(s["graph_captures"] == s["spec_graphs"] == len(set(keys)),
          f"{label}: {s['graph_captures']} captures, {s['spec_graphs']} "
          f"spec graphs for {len(set(keys))} keys {key_names(Counter(keys))}")
    check(per_key == want and runs["fum"] == sum(want.values())
          == N_LAYERS_QWEN * (s["spec_rounds"] + s["graph_captures"])
          and runs["block"] == 0,
          f"{label}: FUM runs on the card by (k, tier) "
          f"{key_names(per_key)}, expected {key_names(want)} (28 x (rounds "
          f"+ 1 warm-up)); in all {runs}")
    log(f"[tune] {label}: rounds by (k, tier) {key_names(Counter(keys))}, "
        f"each captured once; FUM runs on the card {key_names(per_key)} "
        f"= 28 x (rounds + 1 warm-up), {runs['fum']} in all")
    return per_key


def phase_autotune(torch, cfg, params, h1_tokens):
    """qwen2-1.5b at full width on phase 5's weights and traffic: (a) the
    H100 hardware profile against measurements on the card (memory, a
    device copy's bandwidth and a bf16 matmul's rate at most the
    profile's peaks, the dispatch constants beside the profile's); (b)
    the cost policy, graphed at horizon 4, on a tuner that finds every
    signature ambiguous, so each is probed on the card (tokens equal
    phase 5's, the FUM kernel kept, one probe per pending signature, one
    capture per epoch, the FUM kernel's runs = 28 x (decode steps +
    warm-ups) + its probe runs), then the same traffic again on the
    settled decisions (no probe, no capture; the requests that differ
    from phase 5's printed with phase 5's top-2 margin where they part);
    (c) a warm start from the saved cache (no probe, the settled serve's
    decisions and tokens; a CPU cache refused); (d)
    acceptance-adaptive speculation at draft_len 4, graphed: natural
    and on the forced plan (tokens equal phase 5's horizon-1 tokens,
    each (k, tier) captured once, the FUM runs per key 28 x (rounds + 1
    warm-up)), beside fixed draft_len 4 and horizon 1 on the same
    traffic. Returns the FUM runs on the card by serve, the sub-phases'
    wall seconds and what they measured."""
    import numpy as np
    from repro_torch.attention import AttnSpec
    from repro_torch.autotune import SpecController, Tuner, reset_default_tuner
    from repro_torch.launch.measure_profile import measure
    from repro_torch.roofline.hardware import (CARD_PROFILES, H100_SXM,
                                               HOST_CPU, detect_profile)
    from repro_torch.serving import Engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    out, secs, fum = {}, {}, {}

    def sub(name, t0):
        secs[name] = round(time.perf_counter() - t0, 2)
        log(f"[tune] ({name}) wall {secs[name]:.2f} s")

    # ---- (a) the hardware profile against the card
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    prof = detect_profile()
    check(prof is H100_SXM and detect_profile("cuda") is H100_SXM
          and CARD_PROFILES.get(name) is H100_SXM,
          f"detect_profile() on {name!r} gave {prof.name!r}, expected "
          f"{H100_SXM.name!r}")
    check(detect_profile("cpu") is HOST_CPU, "the CPU's profile")
    rec = measure(torch)
    check(rec["total_memory"] == prof.mem_bytes,
          f"total_memory {rec['total_memory']} != the profile's "
          f"mem_bytes {prof.mem_bytes}")
    check(0 < rec["copy_bytes_s"] <= PEAK_SLACK * prof.hbm_bw,
          f"a device copy moved {rec['copy_bytes_s'] / 1e12:.3f} TB/s, "
          f"above {PEAK_SLACK} x the profile's hbm_bw "
          f"{prof.hbm_bw / 1e12:.3f} TB/s")
    check(0 < rec["matmul_bf16_flop_s"] <= PEAK_SLACK * prof.peak_flops,
          f"a bf16 8192^3 matmul ran {rec['matmul_bf16_flop_s'] / 1e12:.1f} "
          f"TFLOP/s, above {PEAK_SLACK} x the profile's peak_flops "
          f"{prof.peak_flops / 1e12:.1f}")
    log(f"[tune] profile {prof.name} for {name!r}: mem_bytes "
        f"{prof.mem_bytes} (total_memory {rec['total_memory']}); device "
        f"copy of 1 GiB (read + write) {rec['copy_bytes_s'] / 1e12:.4f} "
        f"TB/s = {rec['copy_bytes_s'] / prof.hbm_bw:.4f} of hbm_bw "
        f"{prof.hbm_bw / 1e12:.3f} TB/s; bf16 8192^3 matmul "
        f"{rec['matmul_bf16_flop_s'] / 1e12:.2f} TFLOP/s = "
        f"{rec['matmul_bf16_flop_s'] / prof.peak_flops:.4f} of peak_flops "
        f"{prof.peak_flops / 1e12:.1f}")
    log(f"[tune] dispatch_s measured {rec['dispatch_s']:.4e} s (one replay "
        f"of a one-kernel graph, synchronized, median of 200) beside the "
        f"profile's {prof.dispatch_s:.4e}; op_overhead_s measured "
        f"{rec['op_overhead_s']:.4e} s (a {rec['op_graph_nodes']}-kernel "
        f"graph's device time per node, median of 20) beside the "
        f"profile's {prof.op_overhead_s:.4e}")
    out["profile"] = {k: rec[k] for k in (
        "copy_bytes_s", "matmul_bf16_flop_s", "dispatch_s", "op_overhead_s")}
    sub("a", t0)

    # ---- (b) the cost policy, every signature probed on the card
    t0 = time.perf_counter()
    kw = dict(SERVE_KW, decode_horizon=4)
    cost = AttnSpec(policy="cost")
    tuner = Tuner(margin=1e9, probe_reps=PROBE_REPS)
    check(tuner.hw is H100_SXM and tuner.device.type == "cuda",
          f"the tuner prices with {tuner.hw.name} and probes on "
          f"{tuner.device}")
    pending_seen = []
    flush = tuner.flush_probes

    def recording_flush():
        if tuner.pending:
            pending_seen.append({k: v[2] for k, v in tuner.pending.items()})
        return flush()

    tuner.flush_probes = recording_flush
    try:
        eng = Engine(cfg, params, device="cuda", attn=cost, tuner=tuner,
                     **kw)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        epochs = eng._attn_epoch
        label = "cost policy, graphed, horizon 4"
        check(tok == h1_tokens, f"{label}: tokens differ from phase 5's: "
              f"{first_divergence(tok, h1_tokens)}")
        check(s["attn_policy"] == "cost"
              and s["attn_backend_decode"] == "pallas_paged_decode"
              and s["attn_decode_stage3"] == "cuda:hdp_paged_fum_decode",
              f"{label}: decode resolved to {s['attn_backend_decode']} "
              f"({s['attn_decode_stage3']}) under policy {s['attn_policy']}"
              f"; probe times {tuner.probe_times}, tuner {tuner.stats()}, "
              f"probed {pending_seen}")
        pending = {k: v for p in pending_seen for k, v in p.items()}
        st = tuner.stats()
        check(st["probes"] == sum(map(len, pending_seen)) == len(pending)
              > 0 and st["pending"] == 0
              and set(tuner.measured) == set(pending)
              == set(tuner.probe_times),
              f"{label}: {st} after flushes of {pending_seen}; every "
              "pending signature must become one measured entry")
        for key, times in tuner.probe_times.items():
            log(f"[tune] probe {key}: candidates "
                + ", ".join(f"{n} {t * 1e3:.4f} ms" for n, t in times.items())
                + f"; measured winner {tuner.measured[key]}, decision "
                f"{tuner.decision[key]}")
        check(s["graph_captures"] == 1 + epochs,
              f"{label}: {s['graph_captures']} captures over {epochs} "
              "attention epoch bump(s), expected 1 + bumps")
        # each probed candidate runs once untimed and probe_reps times:
        # the FUM kernel for pallas_paged_decode, the block tile kernel
        # (fp32 V) for the block route
        reps = 1 + tuner.probe_reps
        probed_fum = sum("pallas_paged_decode" in names
                         for names in pending.values())
        probed_block = sum("pallas_hdp_block" in names
                           for names in pending.values())
        probe_runs = reps * probed_fum
        want = s["fum_kernel_launches"] + N_LAYERS_QWEN * s["graph_captures"]
        check(s["fum_kernel_launches"] == N_LAYERS_QWEN * s["decode_steps"]
              and runs["fum"] == want + probe_runs
              and runs["block"] == reps * probed_block,
              f"{label}: {runs} kernel runs on the card, expected "
              f"{want + probe_runs} FUM runs = 28 x ({s['decode_steps']} "
              f"decode steps + {s['graph_captures']} warm-ups) + "
              f"{probe_runs} probe runs ({reps} x {probed_fum} probed "
              f"signature(s) listing the FUM kernel), and "
              f"{reps * probed_block} block tile runs (the block route's "
              "probes)")
        log(f"[tune] {label}: tokens == phase 5's; {runs['fum']} FUM runs "
            f"on the card = 28 x ({s['decode_steps']} decode steps + "
            f"{s['graph_captures']} warm-up(s)) + {probe_runs} probe runs "
            f"({reps} x {probed_fum}), block tile runs {runs['block']} "
            f"(the block route's probes); {len(pending)} "
            f"signatures probed, {epochs} epoch bump(s), "
            f"{s['graph_captures']} capture(s); tuner hits/misses "
            f"{s['tuner_hits']}/{s['tuner_misses']} (consultations); "
            f"pred_decode_step_s {s['pred_decode_step_s']:.4e} beside "
            f"meas_decode_step_s {s['meas_decode_step_s']:.4e} (decode_s "
            f"over decode steps, the capture included); decode_tok_s "
            f"{s['decode_tok_s']:.1f} (without the capture "
            f"{s['decode_tok_s_steady']:.1f})")
        fum[f"qwen2-1.5b cost policy, graphed, horizon 4 (with "
            f"{probe_runs} probe runs)"] = runs["fum"]
        # the same traffic again on the settled decisions: no probe, no
        # capture; a flipped prefill decision serves its backend now
        tok2, s2, _, _, runs2 = serve(torch, eng, prompts, 32)
        del eng
        del tuner.flush_probes
        steps2 = s2["decode_steps"] - s["decode_steps"]
        check(tuner.probes == st["probes"] and not tuner.pending
              and s2["graph_captures"] == s["graph_captures"]
              and runs2["fum"] == N_LAYERS_QWEN * steps2
              and runs2["block"] == 0,
              f"{label}, settled: probes {tuner.probes}, captures "
              f"{s2['graph_captures']}, runs {runs2} over {steps2} steps")
        settled = {p: s2[f"attn_backend_{p}"] for p in ("prefill", "decode")}
        moved = first_divergence(tok2, h1_tokens)
        margins = {}
        for u, (i, _, _) in sorted(moved.items()):
            m, top1, *_ = top2_margin(torch, cfg, params, prompts[u],
                                      h1_tokens[u], i)
            margins[u] = (i, round(m / bf16_ulp(top1), 1))
        log(f"[tune] {label}, the same traffic on the settled decisions "
            f"{settled}: no probe, no capture, {runs2['fum']} FUM runs = 28 "
            f"x {steps2} decode steps; {len(moved)} of 8 requests differ "
            "from phase 5's (uid: first index, phase 5's top-2 margin "
            f"there in bf16 ulps) {margins}")
        out["cost_settled"] = dict(backends=settled, differ=margins)
        out["cost"] = dict(
            probes=st["probes"], epochs=epochs, captures=s["graph_captures"],
            probe_ms={k: {n: t * 1e3 for n, t in v.items()}
                      for k, v in tuner.probe_times.items()},
            pred_decode_step_s=s["pred_decode_step_s"],
            meas_decode_step_s=s["meas_decode_step_s"],
            decode_tok_s=s["decode_tok_s"],
            decode_tok_s_steady=s["decode_tok_s_steady"])
        sub("b", t0)

        # ---- (c) warm start from the saved cache
        t0 = time.perf_counter()
        cache_dir = ROOT / "build"
        cache_dir.mkdir(exist_ok=True)
        path = str(cache_dir / "tuner_5h.json")
        tuner.save(path)
        warm = Tuner(cache_path=path)
        check(warm.measured == tuner.measured,
              f"warm start loaded {warm.measured}, saved {tuner.measured}")
        eng = Engine(cfg, params, device="cuda", attn=cost, tuner=warm, **kw)
        wtok, ws, _, _, wruns = serve(torch, eng, prompts, 32)
        del eng
        check(wtok == tok2 and ws["tuner_probes"] == 0
              and warm.decision == tuner.decision
              and ws["graph_captures"] == 1
              and wruns["fum"] == N_LAYERS_QWEN * (ws["decode_steps"] + 1),
              f"warm start: probes {ws['tuner_probes']}, decisions "
              f"{warm.decision} vs {tuner.decision}, captures "
              f"{ws['graph_captures']}, FUM runs {wruns}, tokens equal "
              f"the settled serve's {wtok == tok2}")
        cpu_path = str(cache_dir / "tuner_5h_cpu.json")
        cpu = Tuner(hw=HOST_CPU)
        cpu.measured.update(tuner.measured)
        cpu.save(cpu_path)
        check(Tuner().load(cpu_path) is False,
              "a tuner on the card loaded a host_cpu cache")
        log(f"[tune] warm start: {len(warm.measured)} measured entries "
            f"loaded, 0 probes, the settled serve's decisions and tokens, "
            f"one capture; a host_cpu cache refused on the card")
        fum["qwen2-1.5b cost policy warm start, graphed, horizon 4"] = \
            wruns["fum"]
        sub("c", t0)
    finally:
        reset_default_tuner()

    # ---- (d) acceptance-adaptive speculation, graphed
    t0 = time.perf_counter()
    rates = {}
    for label, ekw in (
            ("adaptive, draft_len 4", dict(spec_decode=True, draft_len=4,
                                           adaptive_spec=True)),
            ("forced plan, draft_len 4", dict(spec_decode=True, draft_len=4,
                                              adaptive_spec=True)),
            ("fixed draft_len 4", dict(spec_decode=True, draft_len=4)),
            ("horizon 1", dict(spec_decode=False, decode_horizon=1))):
        eng = Engine(cfg, params, device="cuda", **ekw, **SERVE_KW)
        forced = None
        if label.startswith("forced"):
            forced = eng.spec_ctl = ForcedPlan(eng.spec_ctl)
        rounds = count_rounds(torch, eng) if eng.spec else None
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        if rounds is not None:
            del eng._run
        bad = first_divergence(tok, h1_tokens)
        check(not bad, f"{label}: tokens differ from phase 5's graphed "
              f"horizon-1 tokens (uid: first index, this, horizon 1): {bad}")
        rates[label] = (s["decode_tok_s"], s["decode_tok_s_steady"])
        if eng.spec:
            per_key = check_round_runs(s, rounds, runs, label)
            if forced is not None:
                # the stand-in plans; the controller behind it only folds
                # the acceptance in, so its own draft_len_mean stays 0
                s["draft_len_mean"] = sum(forced.plans) / len(forced.plans)
                check(forced.plans[:len(FORCED_PLAN)] == list(FORCED_PLAN),
                      f"{label}: plans {forced.plans}")
                check({key for key, _, _ in rounds}
                      == {(4, "aggressive"), (1, None), (2, "base"),
                          (3, "aggressive")},
                      f"{label}: keys {key_names(per_key)}")
            log(f"[tune] {label}: tokens == phase 5's horizon 1; rounds "
                f"{s['spec_rounds']}, acceptance_rate "
                f"{s['acceptance_rate']:.4f}"
                + (f", acceptance_ema {s['acceptance_ema']:.4f}, "
                   f"draft_len_mean {s['draft_len_mean']:.4f}"
                   if s["adaptive_spec"] else "")
                + f"; {s['spec_graphs']} spec graph(s) hold "
                f"{s['graph_allocated_bytes'] / 2**20:.2f} MiB allocated / "
                f"{s['graph_reserved_bytes'] / 2**20:.2f} MiB reserved")
            out[label] = dict(
                rounds=s["spec_rounds"], acceptance_rate=s["acceptance_rate"],
                graphs=s["spec_graphs"], runs=key_names(per_key),
                graph_allocated_bytes=s["graph_allocated_bytes"],
                graph_reserved_bytes=s["graph_reserved_bytes"])
            if s["adaptive_spec"]:
                out[label].update(acceptance_ema=s["acceptance_ema"],
                                  draft_len_mean=s["draft_len_mean"])
            fum[f"qwen2-1.5b {label}, graphed"] = runs["fum"]
        del eng
    log("[tune] decode tok/s on phase 5's traffic (with the captures / "
        "without): " + "; ".join(f"{k} {a:.1f} / {b:.1f}"
                                 for k, (a, b) in rates.items()))
    out["decode_tok_s"] = rates
    sub("d", t0)
    out["secs"] = secs
    out["fum_runs"] = fum
    return out


# ------------------------------------------- phase 5b: granite-8b serving
# ------------------------------------------------- phase 5k: tensor parallel
#: ranks of phase 5k's gloo world, both on the one card
TP_RANKS = 2
#: seconds phase 5k waits for its ranks, and each collective's timeout
TP_DEADLINE_S = 300
TP_COLLECTIVE_TIMEOUT_S = 120


def serving_prompts(cfg, rng):
    """Phase 5's 8 prompts of 200-1,000 tokens from ``rng``."""
    return [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(200, 1001, size=8)]


def weight_checksum(torch, params):
    """Exact checksum of a params tree: the sum of every leaf's bits read
    as integers."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return sum(int(t.contiguous().view(ints[t.element_size()])
                   .to(torch.int64).sum()) for t in _leaves(params))


def tp_rank_serve(torch, rank):
    """One rank of phase 5k: qwen2-1.5b at full width from phase 5's seed,
    ``Engine(tp=2)`` refused with graphs, then phase 5's traffic eagerly
    at horizons 1 and 4 with half the pool's KV heads, the FUM kernel's
    calls and its runs on the card counted. Returns what the parent
    checks, as JSON-ready values."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.distribution.tp import gather_route
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.models import registry
    from repro_torch.serving import Engine
    cfg = get_config("qwen2-1.5b")
    params = registry.init_params(cfg, 0, "cuda")
    out = {"rank": rank, "checksum": weight_checksum(torch, params)}
    prompts = serving_prompts(cfg, np.random.default_rng(0))
    try:
        Engine(cfg, params, device="cuda", tp=TP_RANKS, **SERVE_KW)
        out["graph_error"] = None
    except ValueError as e:
        out["graph_error"] = str(e)
    heads = Counter()

    def counting(*args, **kw):
        heads[int(args[0].shape[1])] += 1
        return hdp_paged_fum_decode(*args, **kw)

    for horizon in (1, 4):
        eng = Engine(cfg, params, device="cuda", cuda_graph=False,
                     tp=TP_RANKS, decode_horizon=horizon, **SERVE_KW)
        heads.clear()
        attention.hdp_paged_fum_decode = counting
        try:
            tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        finally:
            attention.hdp_paged_fum_decode = hdp_paged_fum_decode
        out[f"h{horizon}"] = {
            "tokens": {str(u): t for u, t in tok.items()},
            "wall_s": wall, "decode_tok_s": s["decode_tok_s"],
            "decode_steps": s["decode_steps"],
            "fum_kernel_launches": s["fum_kernel_launches"],
            "runs": runs, "fum_calls_by_heads": dict(heads),
            "fum_by_path": launches["fum"],
            "summary": {k: s[k] for k in (
                "tp", "mesh_shape", "cache_bytes_pool",
                "cache_bytes_pool_per_shard", "collective_bytes_per_layer",
                "cuda_graph", "attn_decode_stage3", "block_sparsity",
                "head_sparsity", "page_sparsity", "prefill_s")},
            "route": gather_route(eng.mesh, "cuda")}
        del eng
    return out


def tp_rank_main(argv):
    """``chip_smoke.py --tp-rank R --tp-store PATH --tp-out PATH``: one
    rank of phase 5k, joined to the gloo world of ``TP_RANKS`` ranks
    through the FileStore at PATH, its result written to the out PATH."""
    import argparse
    import datetime
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp-rank", type=int, required=True)
    ap.add_argument("--tp-store", required=True)
    ap.add_argument("--tp-out", required=True)
    a = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.tp_store, TP_RANKS),
        rank=a.tp_rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
    try:
        with torch.inference_mode():
            res = tp_rank_serve(torch, a.tp_rank)
    finally:
        dist.destroy_process_group()
    tmp = a.tp_out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f)
    Path(tmp).rename(a.tp_out)
    return 0


def phase_tp(torch, cfg, params, phase5, smi_line):
    """Tensor parallelism (ROADMAP item 8): two ranks on the one card in
    a gloo world (NCCL takes one rank per device), each a subprocess of
    this script that rebuilds phase 5's weights from its seed and serves
    phase 5's traffic at tp 2, eagerly at horizons 1 and 4: each rank's
    tokens equal phase 5's, the FUM kernel runs 28 times a decode step on
    each rank at one KV head of two, each rank's pool is half of phase
    5's, and ``Engine(tp=2)`` with graphs raises. A rank that fails,
    times out or exits non-zero fails the phase."""
    import tempfile
    want_sum = weight_checksum(torch, params)
    tmp = Path(tempfile.mkdtemp(prefix="tp_smoke_"))
    procs, logs = [], []
    try:
        for r in range(TP_RANKS):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--tp-rank", str(r), "--tp-store", str(tmp / "store"),
                 "--tp-out", str(tmp / f"rank{r}.json")],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=str(ROOT)))
        end = time.monotonic() + TP_DEADLINE_S
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        tail = (tmp / f"rank{r}.log").read_text()[-3000:]
        check(code == 0, f"tp rank {r} "
              + ("timed out" if code is None else f"exited {code}")
              + f":\n{tail}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(TP_RANKS)]
    want_tok = {str(u): t for u, t in phase5["h1_tokens"].items()}
    for res in ranks:
        r = res["rank"]
        check(res["checksum"] == want_sum, f"tp rank {r}: weight checksum "
              f"{res['checksum']} != phase 5's {want_sum}")
        check(res["graph_error"] is not None
              and "cuda_graph=False" in res["graph_error"],
              f"tp rank {r}: Engine(tp=2) with graphs did not raise "
              f"({res['graph_error']})")
        for horizon in (1, 4):
            h = res[f"h{horizon}"]
            label = f"tp rank {r}, horizon {horizon}"
            s = h["summary"]
            check(h["tokens"] == want_tok, f"{label}: tokens differ from "
                  "phase 5's")
            steps = h["decode_steps"]
            check(h["runs"]["fum"] == N_LAYERS_QWEN * steps
                  == h["fum_kernel_launches"] and h["runs"]["block"] == 0,
                  f"{label}: {h['runs']} runs on the card, "
                  f"{h['fum_kernel_launches']} launches counted, expected "
                  f"{N_LAYERS_QWEN} x {steps} decode steps of the FUM kernel")
            check(h["fum_calls_by_heads"] == {
                str(cfg.n_kv_heads // TP_RANKS): N_LAYERS_QWEN * steps},
                f"{label}: FUM calls by local kv heads "
                f"{h['fum_calls_by_heads']}")
            check(s["tp"] == TP_RANKS and s["mesh_shape"] == {
                "data": 1, "model": TP_RANKS} and not s["cuda_graph"]
                and s["attn_decode_stage3"] == "cuda:hdp_paged_fum_decode",
                f"{label}: summary {s}")
            check(s["cache_bytes_pool"] == phase5["cache_bytes_pool"]
                  and s["cache_bytes_pool_per_shard"] * TP_RANKS
                  == phase5["cache_bytes_pool"],
                  f"{label}: pool {s['cache_bytes_pool']} B, "
                  f"{s['cache_bytes_pool_per_shard']} B per shard; phase 5's "
                  f"{phase5['cache_bytes_pool']} B")
            check(h["route"] == "broadcast", f"{label}: gather route "
                  f"{h['route']}, expected broadcast (gloo, CUDA tensors)")
            log(f"[tp] {label}: wall {h['wall_s']:.2f} s, decode_tok_s "
                f"{h['decode_tok_s']:.1f}, {steps} decode steps, "
                f"{h['runs']['fum']} runs of the fum kernel on the card = "
                f"{N_LAYERS_QWEN} layers x {steps} steps at "
                f"{cfg.n_kv_heads // TP_RANKS} kv head(s), tokens == phase "
                f"5's, pool {s['cache_bytes_pool_per_shard']} B of "
                f"{s['cache_bytes_pool']} B, collective_bytes_per_layer "
                f"{s['collective_bytes_per_layer']}, gather route "
                f"{h['route']}, prefill_s {s['prefill_s']:.3f}; {smi_line}")
    return {"runs_per_rank_h1": ranks[0]["h1"]["runs"]["fum"],
            "fum_by_path": ranks[0]["h1"]["fum_by_path"],
            "runs_per_rank_h4": ranks[0]["h4"]["runs"]["fum"],
            "wall_s": {f"rank{x['rank']} h{h}": x[f"h{h}"]["wall_s"]
                       for x in ranks for h in (1, 4)},
            "decode_tok_s": {f"rank{x['rank']} h{h}":
                             x[f"h{h}"]["decode_tok_s"]
                             for x in ranks for h in (1, 4)},
            "collective_bytes_per_layer":
                ranks[0]["h1"]["summary"]["collective_bytes_per_layer"],
            "cache_bytes_pool_per_shard":
                ranks[0]["h1"]["summary"]["cache_bytes_pool_per_shard"],
            "graph_error": ranks[0]["graph_error"]}


N_LAYERS_GRANITE = 36
#: the depth phase 5b serves granite-8b at (each route's serve at full
#: depth took ~15 s, mostly the plain ``xla_hdp`` prefill's layers)
GRANITE_LAYERS = 4
GRANITE_KW = dict(max_batch=8, max_len=4096 + 32,
                  prefill_buckets=(1024, 2048, 4096), collect_stats=True)


def granite_runs(cfg):
    """(label, config, attn spec, decode backend, decode stage 3, the FUM
    kernel's pool format or None) of each serving route on granite-8b."""
    from repro_torch.attention import AttnSpec
    off = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    fum = "cuda:hdp_paged_fum_decode"
    return [
        ("int8 grid pool", cfg, AttnSpec(kv_dtype="int8"),
         "pallas_paged_decode", fum, "int8"),
        ("fp8_v pool", cfg, AttnSpec(kv_dtype="fp8_v"),
         "pallas_paged_decode", fum, "fp8_v"),
        ("bf16 pool (kv_dtype fp32)", cfg, AttnSpec(kv_dtype="fp32"),
         "pallas_paged_decode", fum, "bf16"),
        ("int8 absmax pool", cfg, AttnSpec(kv_dtype="int8",
                                           kv_scale="absmax"),
         "pallas_paged_decode", "paged_hdp_decode", None),
        ("HDP off, paged int8 pool", off, AttnSpec(kv_dtype="int8"),
         "xla_dense", "xla_dense", None),
        ("HDP off, dense layout", off, AttnSpec(layout="dense"),
         "xla_dense", "xla_dense", None),
        ("HDP on, dense layout", cfg, AttnSpec(layout="dense"),
         "xla_hdp", "xla_hdp", None),
    ]


def phase_granite(torch):
    """granite-8b at full width cut to ``GRANITE_LAYERS`` of its 36 layers
    (bf16, seeded weights): 8 requests of up to 4,096 prompt tokens and
    32 new tokens on every serving route, eagerly and on the decode
    graph at horizon 4 with equal tokens; the FUM kernel's runs counted
    on the card. Then the
    reduced config on the card (graphed) against the CPU on each pool and
    layout. Returns the FUM kernel's runs on the card in the graphed
    serve of each pool format and a summary per route."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.serving import Engine, Request
    cfg = get_config("granite-8b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings)
          == (N_LAYERS_GRANITE, 4096, 32, 8, 128, 14336, 49152, False),
          f"unexpected granite-8b config {cfg}")
    cfg = cfg.replace(n_layers=GRANITE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    log(f"[granite] bf16 weights ({cfg.param_count() / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(17)
    lens = [int(n) for n in rng.integers(256, 4097, size=7)] + [4096]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    log(f"[granite] prompt lengths {lens}")
    runs_by_fmt, routes = {}, {}
    for label, c, spec, backend, stage3, fmt in granite_runs(cfg):
        toks = {}
        for graphed in (False, True):
            torch.cuda.empty_cache()
            eng = Engine(c, params, device="cuda", attn=spec,
                         cuda_graph=graphed, decode_horizon=4 if graphed
                         else 1, **GRANITE_KW)
            tag = f"granite-8b {label}, " + (
                "graphed, horizon 4" if graphed else "eager, horizon 1")
            toks[graphed], s, wall, launches, runs = serve(
                torch, eng, prompts, 32)
            pools = {k: str(v.dtype).replace("torch.", "")
                     for k, v in eng._store.cache.items()}
            del eng
            log_served(tag, s, wall)
            log(f"[granite] {tag}: backends prefill "
                f"{s['attn_backend_prefill']} / decode "
                f"{s['attn_backend_decode']} (stage 3 "
                f"{s['attn_decode_stage3']}), layout {s['layout']}, "
                f"kv_dtype {s['kv_dtype']}, kv_scale {s['kv_scale']}, "
                f"pools {pools}, cache_bytes_per_token "
                f"{s['cache_bytes_per_token']}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check(s["attn_backend_decode"] == backend
                  and s["attn_decode_stage3"] == stage3,
                  f"{tag}: decode resolved to {s['attn_backend_decode']} "
                  f"(stage 3 {s['attn_decode_stage3']}), expected "
                  f"{backend} ({stage3})")
            if fmt is not None:
                check_decode_launches(s, launches, "fum", tag, runs,
                                      n_layers=GRANITE_LAYERS)
                got = launches["fum_format"]
                check(got[fmt] == sum(got.values()),
                      f"{tag}: FUM launches by format {got}, expected "
                      f"all {fmt}")
                if graphed:
                    runs_by_fmt[fmt] = runs["fum"]
            else:
                check(s["fum_kernel_launches"] == 0
                      and not any(launches["fum"].values())
                      and runs["fum"] == 0,
                      f"{tag}: the FUM kernel ran ({launches['fum']}, "
                      f"{runs['fum']} runs on the card)")
            routes.setdefault(label, {})["graphed" if graphed else "eager"] \
                = {k: s[k] for k in ("decode_tok_s", "decode_tok_s_steady",
                                     "prefill_s", "cache_bytes_per_token")}
        check(toks[True] == toks[False],
              f"granite-8b {label}: graphed tokens differ from the eager "
              f"run's: {toks[True]} vs {toks[False]}")
        log(f"[granite] {label}: graphed horizon-4 tokens == eager")
    del params
    torch.cuda.empty_cache()

    # agreement with a reference on a small input: reduced granite on
    # the card (graphed, kernels) and on the CPU (plain versions), same
    # weights, on every pool and layout of the routes above
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    prng = np.random.default_rng(4)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(3)] + [prng.integers(1, 250, size=40).tolist()]
    for label, c, spec, *_ in granite_runs(small):
        gpu = Engine(c, device="cuda", seed=2, attn=spec, decode_horizon=4,
                     **kw)
        cpu = Engine(c, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", attn=spec, **kw)
        toks = []
        for e in (gpu, cpu):
            for uid, p in enumerate(sp):
                e.submit(Request(uid, p, max_new_tokens=8))
            toks.append({u: r.tokens for u, r in e.run().items()})
        check(toks[0] == toks[1], f"reduced granite-8b {label}: card tokens "
              f"{toks[0]} != CPU tokens {toks[1]}")
        log(f"[granite] reduced granite-8b {label}: card tokens (graphed, "
            "horizon 4) == CPU plain-path tokens")
    return runs_by_fmt, routes


# ----------------------------------- phase 5c: windowed decode (h2o-danube)
def phase_window(torch):
    """h2o-danube-1.8b at full width, cut to 4 layers, with its sliding
    window cut to 512 so that prompts of 600-1,000 tokens run past it:
    the paged decode resolves to ``paged_hdp_decode`` (the kernels cannot
    express the window's lower bound), eagerly and graphed with equal
    tokens; the reduced config (window 16) card vs CPU."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.serving import Engine, Request
    full = get_config("h2o-danube-1.8b")
    check(full.sliding_window == 4096, f"unexpected h2o-danube {full}")
    cfg = full.replace(n_layers=4, sliding_window=512)
    params = registry.init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(600, 1001, size=4)]
    kw = dict(max_batch=4, max_len=1056, prefill_buckets=(256, 512, 1024),
              collect_stats=True)
    toks = {}
    for graphed in (False, True):
        eng = Engine(cfg, params, device="cuda", cuda_graph=graphed,
                     decode_horizon=4 if graphed else 1, **kw)
        toks[graphed], s, wall, launches, _ = serve(torch, eng, prompts, 16)
        del eng
        tag = ("h2o-danube-1.8b (4 layers, window 512), "
               + ("graphed, horizon 4" if graphed else "eager"))
        log_served(tag, s, wall)
        check(s["attn_backend_decode"] == "paged_hdp_decode"
              and s["fum_kernel_launches"] == 0,
              f"{tag}: decode resolved to {s['attn_backend_decode']}, FUM "
              f"launches {s['fum_kernel_launches']}")
        log(f"[window] {tag}: decode {s['attn_backend_decode']}, prompts "
            f"{[len(p) for p in prompts]} > window {cfg.sliding_window}")
    check(toks[True] == toks[False],
          "h2o-danube: graphed tokens differ from the eager run's")
    del params
    small = reduced(full)
    gkw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    gpu = Engine(small, device="cuda", seed=3, decode_horizon=4, **gkw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **gkw)
    prng = np.random.default_rng(6)
    sp = [prng.integers(1, 250, size=int(n)).tolist() for n in (20, 30, 40)]
    out = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        out.append({u: r.tokens for u, r in e.run().items()})
    check(out[0] == out[1], f"reduced h2o-danube: card tokens {out[0]} != "
          f"CPU tokens {out[1]}")
    log(f"[window] reduced h2o-danube (window {small.sliding_window}, "
        f"prompts {[len(p) for p in sp]}): card tokens (graphed) == CPU")


# ----------------------------------- phase 5e: the moe and vlm model stack
N_LAYERS_OLMOE = 16
OLMOE_KW = dict(max_batch=8, max_len=2048 + 32,
                prefill_buckets=(256, 512, 1024, 2048), collect_stats=True)
#: the configs served at full width cut to this depth, with their shapes
#: (layers, d, heads, kv heads, hd, d_ff, vocab, experts, active, shared)
CUT_LAYERS = 4
CUT_CONFIGS = {
    "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 8192, 202048, 16, 1, 1),
    "chameleon-34b": (48, 8192, 64, 8, 128, 22016, 65536, 0, 0, 0),
    "nemotron-4-15b": (32, 6144, 48, 8, 128, 24576, 256000, 0, 0, 0),
}


def _shape(cfg):
    return (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.n_experts_active,
            cfg.n_shared_experts)


def _weights(torch, cfg, label, tag="moe"):
    """Seeded bf16 weights of ``cfg`` built on the card, their size logged
    on a ``[tag]`` line."""
    from repro_torch.models import registry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    log(f"[{tag}] {label}: bf16 weights {cfg.param_count() / 1e9:.3f} B "
        f"params ({registry.param_count(cfg, active_only=True) / 1e9:.3f} B "
        "active), "
        f"{nbytes / 1e9:.2f} GB on the card, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, nbytes


def _check_spec_runs(s, runs, n_layers, label, graphed):
    """A speculative serve launches the FUM kernel ``n_layers`` times per
    verify and never in a draft step; the kernel's own count on the card
    is that per round plus, graphed, one warm-up round per capture."""
    rl = s["round_launches"]
    check(all(v["draft"]["fum_kernel_launches"] == 0
              and v["verify"]["fum_kernel_launches"] == n_layers
              for v in rl.values())
          and s["fum_kernel_launches"] == n_layers * s["spec_rounds"] > 0,
          f"{label}: FUM launches per round part {rl}, "
          f"{s['fum_kernel_launches']} over {s['spec_rounds']} rounds; "
          f"expected {n_layers} a verify and none in the draft steps")
    want = n_layers * (s["spec_rounds"]
                       + (s["graph_captures"] if graphed else 0))
    check(runs["fum"] == want and runs["block"] == 0,
          f"{label}: {runs} kernel runs on the card, expected {want} FUM "
          f"runs ({n_layers} x ({s['spec_rounds']} rounds"
          + (f" + {s['graph_captures']} warm-up rounds)" if graphed else ")")
          + " and no block tile run")
    return want


def phase_moe(torch):
    """olmoe-1b-7b at full width and depth (64 experts top-8, qk-norm,
    MHA, 13.8 GB of bf16 weights): the aligned prefill (B 1, S 4096, the
    MoE's grouped branch) through the scout and block kernels and through
    flash, each held against its plain version at the path's own inputs;
    8 requests of 200-2,000 prompt tokens eagerly and on the decode graph
    at horizons 1 and 4 (equal tokens, 16 FUM runs a decode step on the
    card, the kernel against its plain version at the path's busiest
    call); speculative decode at draft_len 4 graphed and eager (equal
    tokens); the prefix traffic hot and cold. Capacity drops make spec
    against greedy and hot against cold differ at full width (reference
    semantics): their first divergences are printed, not asserted. Then
    llama4-scout, chameleon-34b and nemotron-4-15b at full width cut to
    4 layers, eager and graphed with equal tokens; the four reduced
    configs card (graphed) vs CPU. Returns {run label: FUM runs on the
    card}, the prefill launches and calls, and the olmoe summaries."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.hdp_paged_decode import (fum_splits,
                                                      hdp_paged_fum_decode)
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    from repro_torch.serving import Engine, Request
    cfg = get_config("olmoe-1b-7b")
    check(_shape(cfg) == (N_LAYERS_OLMOE, 2048, 16, 16, 128, 1024, 50304,
                          64, 8, 0) and cfg.qk_norm and cfg.family == "moe",
          f"unexpected olmoe-1b-7b config {cfg}")
    params, wbytes = _weights(torch, cfg, "olmoe-1b-7b (16 layers)")
    fum_runs, out = {}, {"weight_bytes": wbytes}

    # ---- the aligned prefill: B 1, S 4096 (the MoE groups 256 tokens)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        1, cfg.vocab_size, MHA_PREFILL[:1] + MHA_PREFILL[2:3])).cuda()
    out["prefill"], calls = aligned_prefill(torch, cfg, params, toks,
                                            "olmoe-1b-7b")
    check_prefill_calls(torch, calls, "olmoe-1b-7b's aligned prefill")
    out["calls"] = calls
    del toks

    # ---- serving: eager (the FUM call that listed the most pages kept),
    # then graphed at horizons 1 and 4
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 2001, size=8)]
    log(f"[moe] olmoe prompt lengths {[len(p) for p in prompts]}")
    rec = Recorder(hdp_paged_fum_decode, key=listed_pages, clone=True)
    eng = Engine(cfg, params, device="cuda", cuda_graph=False, **OLMOE_KW)
    attention.hdp_paged_fum_decode = rec
    try:
        eager_tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
    finally:
        attention.hdp_paged_fum_decode = hdp_paged_fum_decode
    del eng
    log_served("olmoe-1b-7b eager, horizon 1", s, wall)
    check(s["attn_decode_stage3"] == "cuda:hdp_paged_fum_decode",
          f"olmoe decode stage 3 resolved to {s['attn_decode_stage3']}")
    check_decode_launches(s, launches, "fum", "olmoe-1b-7b eager", runs,
                          n_layers=N_LAYERS_OLMOE)
    check(rec.score is not None and rec.score > 0,
          "olmoe: no FUM call of the path listed a page")
    (args, kw), rec = rec.best, None
    # the pass the rule gives olmoe's decode (B*N = 8 x 16 = 128 rows)
    olmoe_S = fum_splits(*args[0].shape[:2], args[3].shape[1],
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count, args[0].shape[2])
    olmoe_mode = "split" if olmoe_S > 1 else "single"
    check(launches["fum"][olmoe_mode] == sum(launches["fum"].values()),
          f"olmoe-1b-7b eager: FUM launches by pass {launches['fum']}, "
          f"expected every launch {olmoe_mode} (fum_splits: S={olmoe_S})")
    out["fum_mode"], out["fum_S"] = olmoe_mode, olmoe_S
    log(f"[moe] olmoe-1b-7b eager: FUM launches by pass {launches['fum']} "
        f"(B*N = 8 x 16 = 128 rows: fum_splits gives S={olmoe_S}), "
        f"cache_bytes_per_token {s['cache_bytes_per_token']}, weights "
        f"{wbytes} B")
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    for mode, splits in (("default", None), ("split", 3), ("single", 1)):
        got = hdp_paged_fum_decode(*args, **kw, splits=splits)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=ATOL, rtol=RTOL),
            f"olmoe: FUM kernel [{mode}] vs plain at the path's own inputs: "
            f"max |err| {err:.3e}")
        out["fum_err"] = max(out.get("fum_err", 0.0), err)
        log(f"[moe] olmoe: FUM kernel [{mode}, S={splits or 'fum_splits'}] "
            f"vs plain at the path's call that listed the most pages (qq "
            f"{tuple(args[0].shape)}, {listed_pages(args)} pages listed): "
            f"max |err| {err:.3e}")
    del args, kw, ref
    for horizon in (1, 4):
        eng = Engine(cfg, params, device="cuda", decode_horizon=horizon,
                     **OLMOE_KW)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng
        label = f"olmoe-1b-7b graphed, horizon {horizon}"
        log_served(label, s, wall)
        check(tok == eager_tok, f"{label}: tokens differ from the eager "
              f"run's: {first_divergence(tok, eager_tok)}")
        check(s["graph_captures"] == 1, f"{label}: {s['graph_captures']} "
              "graph captures, expected 1")
        check_decode_launches(s, launches, "fum", label, runs,
                              n_layers=N_LAYERS_OLMOE)
        check(launches["fum"][olmoe_mode] == sum(launches["fum"].values()),
              f"{label}: FUM launches by pass {launches['fum']}, expected "
              f"every launch {olmoe_mode} (S={olmoe_S})")
        fum_runs[label] = runs["fum"]
        out[f"h{horizon}"] = {k: s[k] for k in (
            "decode_tok_s", "decode_tok_s_steady", "prefill_s",
            "cache_bytes_per_token", "block_sparsity", "head_sparsity",
            "page_sparsity")}
        if horizon == 1:
            h1_tok = tok
        log(f"[moe] {label}: tokens == eager; FUM launches by pass "
            f"{launches['fum']}")

    # ---- speculative decode, draft_len 4: graphed == eager
    spec_tok = {}
    for graphed in (True, False):
        eng = Engine(cfg, params, device="cuda", spec_decode=True,
                     draft_len=4, cuda_graph=graphed, **OLMOE_KW)
        spec_tok[graphed], s, wall, launches, runs = serve(
            torch, eng, prompts, 32)
        del eng
        label = ("olmoe-1b-7b spec decode, draft_len 4, "
                 + ("graphed" if graphed else "eager"))
        n = _check_spec_runs(s, runs, N_LAYERS_OLMOE, label, graphed)
        if graphed:
            fum_runs[label] = n
        log(f"[moe] {label}: wall {wall:.2f} s, rounds {s['spec_rounds']}, "
            f"acceptance_rate {s['acceptance_rate']:.4f}, decode_tok_s "
            f"{s['decode_tok_s']:.1f} (without the captures "
            f"{s['decode_tok_s_steady']:.1f}), {runs['fum']} FUM runs on "
            f"the card, graphs {s['spec_graphs']}")
        out[f"spec_{'graphed' if graphed else 'eager'}"] = {
            k: s[k] for k in ("acceptance_rate", "decode_tok_s",
                              "decode_tok_s_steady", "spec_rounds")}
    check(spec_tok[True] == spec_tok[False],
          f"olmoe spec decode: graphed tokens differ from eager: "
          f"{first_divergence(spec_tok[True], spec_tok[False])}")
    div = first_divergence(spec_tok[True], h1_tok)
    log(f"[moe] olmoe spec decode: graphed tokens == eager; against the "
        f"graphed horizon-1 greedy tokens {len(div)} of 8 requests differ "
        f"(uid: first index, spec, greedy) {div} (the verify's capacity of "
        f"1 per expert drops tokens; not asserted)")
    out["spec_vs_greedy"] = len(div)

    # ---- the prefix traffic hot and cold (graphed, horizon 4)
    cold_tok, cs, ceng = serve_prefix(torch, cfg, params, False)
    del ceng
    hot_tok, hs, heng = serve_prefix(torch, cfg, params, True)
    check(hs["prefix_hits"] == 8 and hs["cow_copies"] >= 2,
          f"olmoe prefix cache: {hs['prefix_hits']} hits and "
          f"{hs['cow_copies']} COW copies, expected 8 and >= 2")
    heng.prefix.clear()
    heng.pages.allocator.assert_drained()
    del heng
    div = first_divergence(hot_tok, cold_tok)
    log(f"[moe] olmoe prefix cache: hits {hs['prefix_hits']}, COW copies "
        f"{hs['cow_copies']}, pool drained after clear(); prefill_s hot "
        f"{hs['prefill_s']:.3f} vs cold {cs['prefill_s']:.3f}; hot against "
        f"cold {len(div)} of 9 requests differ {div} (a suffix prefill "
        f"groups tokens for capacity unlike a whole one; not asserted)")
    out["hot_vs_cold"] = len(div)
    del params
    torch.cuda.empty_cache()

    # ---- llama4-scout, chameleon-34b, nemotron-4-15b cut to 4 layers
    rng = np.random.default_rng(22)
    for name, shape in CUT_CONFIGS.items():
        full = get_config(name)
        check(_shape(full) == shape, f"unexpected {name} config {full}")
        c = full.replace(n_layers=CUT_LAYERS)
        params, _ = _weights(torch, c, f"{name} cut to {CUT_LAYERS} layers")
        prompts = [rng.integers(1, c.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(200, 1001, size=4)]
        toks = {}
        for graphed in (False, True):
            eng = Engine(c, params, device="cuda", cuda_graph=graphed,
                         decode_horizon=4 if graphed else 1,
                         **dict(SERVE_KW, max_batch=4))
            toks[graphed], s, wall, launches, runs = serve(
                torch, eng, prompts, 16)
            del eng
            label = (f"{name} ({CUT_LAYERS} layers) "
                     + ("graphed, horizon 4" if graphed else "eager"))
            log_served(label, s, wall)
            check_decode_launches(s, launches, "fum", label, runs,
                                  n_layers=CUT_LAYERS)
            check(launches["fum"]["split"] == sum(launches["fum"].values()),
                  f"{label}: FUM launches by pass {launches['fum']}, "
                  "expected every launch split across blocks")
            log(f"[moe] {label}: FUM launches by pass {launches['fum']}, "
                f"G {c.n_heads // c.n_kv_heads}, cache_bytes_per_token "
                f"{s['cache_bytes_per_token']}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if graphed:
                fum_runs[label] = runs["fum"]
        check(toks[True] == toks[False], f"{name}: graphed tokens differ "
              f"from eager: {first_divergence(toks[True], toks[False])}")
        log(f"[moe] {name} ({CUT_LAYERS} layers): graphed horizon-4 tokens "
            "== eager")
        del params
        torch.cuda.empty_cache()

    # ---- the reduced configs: card (graphed, kernels) vs CPU (plain)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    prng = np.random.default_rng(23)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(3)] + [prng.integers(1, 250, size=40).tolist()]
    for name in ("olmoe-1b-7b",) + tuple(CUT_CONFIGS):
        small = reduced(get_config(name))
        gpu = Engine(small, device="cuda", seed=4, decode_horizon=4, **kw)
        cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                             gpu.params.items()}, device="cpu", **kw)
        toks = []
        for e in (gpu, cpu):
            for uid, p in enumerate(sp):
                e.submit(Request(uid, p, max_new_tokens=8))
            toks.append({u: r.tokens for u, r in e.run().items()})
        check(gpu.metrics["graph_captures"] == 1 and toks[0] == toks[1],
              f"reduced {name}: card tokens {toks[0]} != CPU tokens "
              f"{toks[1]} (captures {gpu.metrics['graph_captures']})")
        log(f"[moe] reduced {name} (one prompt of 40 tokens chunked): card "
            "tokens (graphed, horizon 4) == CPU plain-path tokens")
    out["fum_runs"] = fum_runs
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, dev):
    return _tree_map(lambda t: t.to(dev), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ------------- phase 5i: the recurrent and encoder-decoder families
#: rwkv6-3b's and zamba2-7b's serving traffic: 8 prompts of distinct
#: lengths in 64-512; zamba2's Mamba2 layers take the chunked SSD at the
#: two multiples of 128 and the per-step scan at the six others
FAMILY_PLENS = (128, 256, 140, 199, 263, 331, 402, 487)
FAMILY_KW = dict(max_batch=8, max_len=512 + 32, prefill_buckets=(512,))
#: zamba2-7b's shared attention block at its aligned prefill (B 1, S 4096):
#: 32 heads at hd 112, invoked once per group of 6 Mamba2 layers; the
#: scout takes its tensor-core kernel on int8 copies zero-padded to 128
#: columns, block and flash theirs (hd 112 padded to 128 in shared memory)
ZAMBA_GROUPS, ZAMBA_PATHS = 13, {"hdp_scout": "tensor_core",
                                 "hdp_block_sparse_attention": "tensor_core",
                                 "flash_attention": "tensor_core"}
#: whisper-large-v3: frames (B, S_enc), the prompt and the greedy steps
WHISPER_B, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = 2, 1500, 16, 32


def serve_family(torch, cfg, params, prompts, label):
    """``prompts`` served eagerly and on the decode graph at horizon 4:
    identical tokens, one capture, the dense layout, one exact-length
    prefill call per prompt length, and no decode kernel launched (the
    recurrent families decode on ``none`` or ``xla_hdp``). Returns
    {graphed: (tokens, summary, wall s)}."""
    from repro_torch.serving import Engine
    out = {}
    for graphed in (False, True):
        eng = Engine(cfg, params, device="cuda", cuda_graph=graphed,
                     decode_horizon=4 if graphed else 1, **FAMILY_KW)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng
        lbl = f"{label} " + ("graphed, horizon 4" if graphed else "eager")
        log_served(lbl, s, wall)
        check(s["layout"] == "dense" and s["prefill_calls"] == len(prompts)
              and s["prefill_tokens"] == sum(map(len, prompts)),
              f"{lbl}: layout {s['layout']}, {s['prefill_calls']} prefill "
              f"calls of {s['prefill_tokens']} tokens, expected the dense "
              f"layout and {len(prompts)} exact-length calls of "
              f"{sum(map(len, prompts))} tokens")
        check(not any(v for d in launches.values() for v in d.values())
              and runs == {"fum": 0, "block": 0},
              f"{lbl}: decode kernels launched {launches}, ran {runs}")
        if graphed:
            check(s["graph_captures"] == 1, f"{lbl}: "
                  f"{s['graph_captures']} graph captures, expected 1")
        out[graphed] = (tok, s, wall)
    check(out[True][0] == out[False][0], f"{label}: graphed tokens differ "
          f"from eager: {first_divergence(out[True][0], out[False][0])}")
    s = out[True][1]
    log(f"[families] {label}: graphed horizon-4 tokens == eager; "
        f"decode_tok_s eager {out[False][1]['decode_tok_s']:.1f}, graphed "
        f"{s['decode_tok_s']:.1f} (steady {s['decode_tok_s_steady']:.1f}); "
        f"prefill_s {out[False][1]['prefill_s']:.3f} / {s['prefill_s']:.3f}; "
        f"graph_capture_s {s['graph_capture_s']:.3f}; attn_backend_prefill/"
        f"decode {s['attn_backend_prefill']}/{s['attn_backend_decode']}; "
        f"cache_bytes {s['cache_bytes']}")
    return out


def reduced_card_vs_cpu(torch, name):
    """The reduced config graphed on the card (horizon 4) and on the CPU
    serve the same prompts to the same tokens."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import Engine, Request
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    rng = np.random.default_rng(31)
    sp = [rng.integers(1, 250, size=int(rng.integers(4, 24))).tolist()
          for _ in range(3)] + [rng.integers(1, 250, size=40).tolist()]
    small = reduced(get_config(name))
    gpu = Engine(small, device="cuda", seed=4, decode_horizon=4, **kw)
    cpu = Engine(small, _tree_to(gpu.params, "cpu"), device="cpu", **kw)
    toks = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
    check(gpu.metrics["graph_captures"] == 1 and toks[0] == toks[1],
          f"reduced {name}: card tokens {toks[0]} != CPU tokens {toks[1]} "
          f"(captures {gpu.metrics['graph_captures']})")
    log(f"[families] reduced {name} (a 40-token prompt prefilled at exact "
        "length): card tokens (graphed, horizon 4) == CPU tokens")


def whisper_greedy(torch, cfg, params, frames, prompt, steps):
    """``registry.apply_prefill`` (encode the frames, prefill the prompt,
    fill the self and cross caches), then ``steps`` greedy
    ``apply_decode`` steps, eagerly; every logit finite. Returns (tokens
    [B, steps], prefill s, decode s)."""
    from repro_torch.models import registry
    dev = frames.device
    B, plen = prompt.shape
    cache = registry.init_cache(cfg, B, plen + steps, device=dev,
                                enc_len=frames.shape[1])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache, _ = registry.apply_prefill(
        cfg, params, {"tokens": prompt, "frames": frames}, cache)
    sync()
    t1 = time.perf_counter()
    toks = []
    for i in range(steps):
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: non-finite logits at step {i}")
        tok = logits[:, -1].argmax(-1)
        toks.append(tok)
        pos = torch.full((B, 1), plen + i, dtype=torch.long, device=dev)
        logits, cache, _ = registry.apply_decode(cfg, params, tok[:, None],
                                                 cache, pos)
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: non-finite logits after the last step")
    sync()
    return torch.stack(toks, 1).cpu(), t1 - t0, time.perf_counter() - t1


def phase_families(torch):
    """rwkv6-3b (32 layers, d 2560) and zamba2-7b (81 layers: 13 groups of
    6 Mamba2 layers and the shared attention block, plus 3; HDP on) at
    full width and depth: 8 prompts of distinct lengths in 64-512, 32
    new tokens each, batch 8, the dense layout, eagerly and graphed at
    horizon 4 (identical tokens, one capture, exact-length prefill, no
    decode kernel); zamba2's aligned prefill (B 1, S 4096) through the
    scout and block kernels with HDP on and flash with HDP off, all on
    the tensor-core path, 13 launches each at hd 112, each held against
    its plain version at the path's own inputs (the scout also against
    its dp4a kernel); whisper-large-v3
    (32 + 32 layers) encoding 2 x 1500 seeded frames, a 16-token prompt
    and 32 greedy decode steps; the reduced configs card vs CPU. Each
    model's weights are freed before the next. Returns zamba2's prefill
    launches, its recorded calls and the kernels' errors."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    out = {}
    rng = np.random.default_rng(30)

    # ---- rwkv6-3b
    cfg = get_config("rwkv6-3b")
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.hdp) ==
          ("rwkv6", 32, 2560, None), f"unexpected rwkv6-3b config {cfg}")
    params, _ = _weights(torch, cfg, "rwkv6-3b (32 layers)", "families")
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in FAMILY_PLENS]
    runs = serve_family(torch, cfg, params, prompts, "rwkv6-3b")
    check(runs[True][1]["attn_backend_decode"] == "none",
          "rwkv6-3b resolved an attention backend")
    out["rwkv6"] = {k: runs[True][1][k] for k in (
        "decode_tok_s", "decode_tok_s_steady", "prefill_s",
        "graph_capture_s")}
    out["rwkv6"]["eager_decode_tok_s"] = runs[False][1]["decode_tok_s"]
    del params, runs
    torch.cuda.empty_cache()

    # ---- zamba2-7b: serving, then the aligned prefill
    cfg = get_config("zamba2-7b")
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd,
           cfg.attn_every, registry.attn_layers(cfg)) ==
          ("zamba2", 81, 3584, 32, 112, 6, ZAMBA_GROUPS)
          and cfg.hdp is not None and cfg.hdp.enabled,
          f"unexpected zamba2-7b config {cfg}")
    params, _ = _weights(torch, cfg, "zamba2-7b (81 layers)", "families")
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in FAMILY_PLENS]
    runs = serve_family(torch, cfg, params, prompts, "zamba2-7b")
    s = runs[True][1]
    check((s["attn_backend_prefill"], s["attn_backend_decode"]) ==
          ("xla_hdp", "xla_hdp"),
          f"zamba2-7b resolved {s['attn_backend_prefill']}/"
          f"{s['attn_backend_decode']}, expected xla_hdp for both")
    out["zamba2"] = {k: s[k] for k in (
        "decode_tok_s", "decode_tok_s_steady", "prefill_s",
        "graph_capture_s")}
    out["zamba2"]["eager_decode_tok_s"] = runs[False][1]["decode_tok_s"]
    del runs
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, PREFILL_S))).cuda()
    out["prefill"], calls = aligned_prefill(
        torch, cfg, params, toks, "zamba2-7b", n_calls=ZAMBA_GROUPS,
        paths=ZAMBA_PATHS)
    out["errs"] = check_prefill_calls(torch, calls, "zamba2-7b's aligned "
                                      "prefill (hd 112)", ZAMBA_PATHS,
                                      twin=True)
    out["calls"] = calls
    del params, toks
    torch.cuda.empty_cache()

    # ---- whisper-large-v3 at model level (the engine refuses enc-dec)
    cfg = get_config("whisper-large-v3")
    check((cfg.family, cfg.encoder_layers, cfg.decoder_layers, cfg.d_model)
          == ("whisper", 32, 32, 1280), f"unexpected whisper config {cfg}")
    params, _ = _weights(torch, cfg, "whisper-large-v3 (32 + 32 layers)",
                         "families")
    g = torch.Generator(device="cuda").manual_seed(32)
    frames = torch.randn(WHISPER_B, WHISPER_FRAMES, cfg.d_model, device="cuda",
                         generator=g).to(torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT))).cuda()
    wt, pre_s, dec_s = whisper_greedy(torch, cfg, params, frames, prompt,
                                      WHISPER_STEPS)
    log(f"[families] whisper-large-v3: frames {tuple(frames.shape)}, prompt "
        f"{WHISPER_PROMPT} tokens: prefill (encode + prompt) {pre_s:.3f} s, "
        f"{WHISPER_STEPS} greedy decode steps {dec_s:.3f} s "
        f"({dec_s / WHISPER_STEPS * 1e3:.2f} ms a step, eager), logits "
        f"finite; tokens {wt.tolist()}")
    out["whisper"] = {"prefill_s": pre_s, "decode_s": dec_s}
    del params, frames
    torch.cuda.empty_cache()

    # ---- the reduced configs: card vs CPU
    for name in ("rwkv6-3b", "zamba2-7b"):
        reduced_card_vs_cpu(torch, name)
    small = reduced(get_config("whisper-large-v3"))
    sp = registry.init_params(small, 4, "cuda")
    sf = torch.randn(2, 24, small.d_model, device="cuda", generator=g)
    pr = torch.from_numpy(rng.integers(1, 250, (2, 6))).cuda()
    card = whisper_greedy(torch, small, sp, sf, pr, 8)[0]
    host = whisper_greedy(torch, small, _tree_to(sp, "cpu"), sf.cpu(),
                          pr.cpu(), 8)[0]
    check(torch.equal(card, host), f"reduced whisper-large-v3: card tokens "
          f"{card.tolist()} != CPU tokens {host.tolist()}")
    log("[families] reduced whisper-large-v3: 8 greedy tokens on the card "
        "== CPU tokens")
    return out


# ------------------------------------------------ phase 5j: training
#: (a) qwen2-1.5b trained at full width and depth: the reference's
#: train_4k shape (S 4096) cut to global batch 8, so micro_batches gives
#: 8 microbatches of 1 x 4096; (b), (c) the same width cut to 2 layers
TRAIN_STEPS, TRAIN_S, TRAIN_B = 4, 4096, 8
CUT_ARCH, CUT_S, CUT_B = "qwen2-1.5b-2l", 2048, 2
#: resumed losses against the uninterrupted run's: a rerun on the card
#: need not sum every gradient in one order (an indexed backward may
#: accumulate with atomics), so the updates may part in the last bits
TRAIN_RESUME_RTOL = 1e-4
#: (d) card vs CPU, one train step on the reduced configs (fp32, TF32
#: off): the CPU tests' tolerances against JAX (atol 1e-5 / rtol 1e-4;
#: master at 0.1 x the peak lr, zamba2 at the peak lr with its grad norm
#: at 1e-3: a Mamba2 layer amplifies fp32 rounding, ROADMAP section 3)
TRAIN_REDUCED = ("qwen2-1.5b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-7b",
                 "whisper-large-v3")


def all_kernel_launches(torch):
    """Every kernel wrapper's launches since ``zero_launches`` and the
    FUM and block tile kernels' runs on the card."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.hdp_scout import hdp_scout
    torch.cuda.synchronize()
    out = {fn.__name__: fn.launches for fn in (
        hdp_paged_fum_decode, hdp_scout, hdp_block_sparse_attention,
        flash_attention)}
    out["fum runs"] = hdp_paged_fum_decode.runs.read()
    out["block runs"] = hdp_block_sparse_attention.runs.read()
    return out


class _StepLog(logging.Handler):
    """Collects (step, loss, grad_norm, seconds) from the launcher's
    per-step log lines (``--log-every 1``)."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.msg.startswith("step "):
            self.steps.append(record.args)


def train_run(torch, *argv):
    """``launch.train.run`` on the card with ``argv``: (its result, the
    per-step (step, loss, grad_norm, s) tuples, the peak memory in
    bytes). No kernel wrapper may launch: a trainable attention call
    takes the plain backends (none of the kernels has a gradient)."""
    import math
    from repro_torch.launch import train
    lg = logging.getLogger("repro_torch.train")
    sl = _StepLog()
    lg.addHandler(sl)
    lg.setLevel(logging.INFO)
    with torch.inference_mode():   # the counters are inference tensors
        zero_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train.run(train.build_parser().parse_args(
            [*argv, "--device", "cuda", "--log-every", "1"]))
    finally:
        lg.removeHandler(sl)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = all_kernel_launches(torch)
    check(not any(launched.values()), f"training {argv}: kernels launched "
          f"{launched}, expected none (trainable calls decline them)")
    check(len(sl.steps) == out["steps"] and all(
        math.isfinite(loss) and math.isfinite(gn)
        for _, loss, gn, _ in sl.steps),
          f"training {argv}: non-finite loss or grad norm {sl.steps}")
    return out, sl.steps, peak


def _bits_equal(torch, a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def train_card_vs_cpu(torch, name):
    """One train step of the reduced config (fp32 weights made on the
    CPU, copied to the card) on the card and on the CPU: loss, grad norm
    and every updated master leaf agree (``TRAIN_REDUCED``'s note)."""
    import numpy as np
    from repro_torch.common import tree
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg = reduced(get_config(name))
    rng = np.random.default_rng(51)
    spec = registry.input_specs(cfg, ShapeConfig(
        "t", 64 if cfg.is_encoder_decoder else 24, 4, "train"))["batch"]
    batch = {k: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, sd.shape).astype(np.int32)
        if k == "tokens" else
        rng.standard_normal(sd.shape).astype(np.float32))
        for k, sd in spec.items()}
    params = registry.init_params(cfg, 4, "cpu")
    ocfg = opt.OptConfig(warmup_steps=1, decay_steps=10)
    step = make_train_step(cfg, ocfg, num_microbatches=2)
    res = {}
    with torch.inference_mode():   # the counters are inference tensors
        zero_launches()
    for dev in ("cuda", "cpu"):
        p = tree.tree_map(lambda t: t.to(dev), params)
        res[dev] = step(p, opt.init_opt_state(p),
                        tree.tree_map(lambda t: t.to(dev), batch))
    launched = all_kernel_launches(torch)
    check(not any(launched.values()),
          f"reduced {name} train step launched kernels {launched}")
    (_, card_o, card_m), (_, host_o, host_m) = res["cuda"], res["cpu"]
    zamba = cfg.family == "zamba2"
    norm_rtol = 1e-3 if zamba else RTOL
    p_atol = ocfg.peak_lr * (1.0 if zamba else 0.1)
    worst = 0.0
    for k, rtol in (("loss", RTOL), ("grad_norm", norm_rtol), ("lr", 1e-6)):
        a, b = float(card_m[k]), float(host_m[k])
        check(abs(a - b) <= 1e-5 + rtol * abs(b),
              f"reduced {name} train step: {k} card {a} != CPU {b}")
    for a, path, b in zip(*tree.flatten_with_paths(card_o["master"]),
                          tree.leaves(host_o["master"])):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        check(bool((d <= p_atol + RTOL * b.abs()).all()),
              f"reduced {name} train step: master{path} card vs CPU max "
              f"|diff| {float(d.max()):.3e} > {p_atol:.1e} + {RTOL} |x|")
    check(int(card_o["step"]) == int(host_o["step"]) == 1,
          f"reduced {name}: step {int(card_o['step'])}")
    log(f"[train] reduced {name} (2 microbatches, warmup 1): card == CPU, "
        f"loss {float(card_m['loss']):.6f} / {float(host_m['loss']):.6f}, "
        f"grad_norm {float(card_m['grad_norm']):.6f} / "
        f"{float(host_m['grad_norm']):.6f}, master max |diff| {worst:.3e}")
    return worst


def phase_train(torch, smi_line):
    """Training (ROADMAP item 11a) through ``launch.train.run``: (a)
    qwen2-1.5b at full width and depth (28 layers, bf16, remat on), S
    4096, global batch 8 in 8 microbatches, 4 steps of synthetic data;
    step seconds, tokens/s, the share of the bf16 peak (6 N tokens per
    step) and the peak memory; (b) the width cut to 2 layers: 4 steps
    uninterrupted, then 2 steps with a checkpoint and a fresh run that
    resumes from it for 2 more (restored state bit-equal to the saved
    state, resumed losses against the uninterrupted run's); (c) one step
    each with bf16 gradient compression and with 2 microbatches; (d) the
    reduced configs card vs CPU. No kernel launches in any of them."""
    import shutil
    import tempfile
    from repro_torch.common import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import register
    from repro_torch.models import registry
    from repro_torch.training import checkpoint as ckpt
    out = {}

    # ---- (a) full width and depth
    cfg = get_config("qwen2-1.5b")
    check(cfg.n_layers == N_LAYERS_QWEN and cfg.remat and
          cfg.dtype == "bfloat16", f"unexpected qwen2-1.5b config {cfg}")
    n_params = registry.param_count(cfg)
    res, steps, peak = train_run(
        torch, "--arch", "qwen2-1.5b", "--seq-len", str(TRAIN_S),
        "--global-batch", str(TRAIN_B), "--steps", str(TRAIN_STEPS))
    secs = [s for *_, s in steps]
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = TRAIN_S * TRAIN_B
    flops = 6 * n_params * tokens
    out["full"] = {
        "losses": [loss for _, loss, _, _ in steps],
        "grad_norms": [gn for _, _, gn, _ in steps],
        "step_s": secs, "first_step_s": secs[0], "steady_step_s": steady,
        "tokens_per_s": tokens / steady,
        "model_flops_per_s": flops / steady,
        "bf16_peak_share": flops / steady / BF16_FLOP_S,
        "peak_mem_gb": peak / 1e9, "wall_s": res["wall_s"],
        "params": n_params}
    log(f"[train] qwen2-1.5b full width and depth (28 layers, bf16, remat, "
        f"{n_params / 1e9:.3f} B params), S {TRAIN_S}, global batch "
        f"{TRAIN_B} in 8 microbatches, {TRAIN_STEPS} steps: losses "
        f"{out['full']['losses']}, grad norms {out['full']['grad_norms']}; "
        f"step s {[round(x, 3) for x in secs]} (first {secs[0]:.3f}, "
        f"steady {steady:.3f}); {tokens / steady:.1f} tokens/s; model "
        f"FLOP/s {flops / steady:.4e} = {flops / steady / BF16_FLOP_S:.4f} "
        f"of the bf16 peak ({BF16_FLOP_S:.3e}); peak memory "
        f"{peak / 1e9:.2f} GB; no kernel launched; {smi_line}")

    # ---- (b) checkpoint and resume at full width cut to 2 layers
    register(lambda: get_config("qwen2-1.5b").replace(name=CUT_ARCH,
                                                      n_layers=2))
    base = ["--arch", CUT_ARCH, "--seq-len", str(CUT_S),
            "--global-batch", str(CUT_B)]
    tmp = tempfile.mkdtemp(prefix="train_5j_")
    saved = {}
    save = ckpt.save_checkpoint

    def spy(directory, step, state, **kw):
        saved[step] = tree.tree_map(lambda t: t.detach().clone(), state)
        return save(directory, step, state, **kw)

    try:
        _, full, _ = train_run(torch, *base, "--steps", "4")
        ckpt.save_checkpoint = spy
        t0 = time.perf_counter()
        _, first, _ = train_run(torch, *base, "--steps", "2",
                                "--checkpoint-dir", tmp,
                                "--checkpoint-interval", "2")
        t_first = time.perf_counter() - t0
        ckpt.save_checkpoint = save
        check(ckpt.latest_step(tmp) == 2, f"no step-2 checkpoint in {tmp}")
        cut = registry.init_params(get_config(CUT_ARCH), device="meta")
        from repro_torch.training import optimizer as opt
        like = {"params": cut, "opt": opt.init_opt_state(cut)}
        t0 = time.perf_counter()
        restored, step, _ = ckpt.load_checkpoint(tmp, like, device="cuda")
        t_load = time.perf_counter() - t0
        pairs = list(zip(*tree.flatten_with_paths(restored),
                         tree.leaves(saved[2])))
        bad = [p for a, p, b in pairs if not _bits_equal(torch, a, b)]
        check(step == 2 and not bad, f"restored checkpoint differs from the "
              f"saved state at {bad[:4]} (step {step})")
        n_bf16 = sum(a.dtype == torch.bfloat16 for a, _, _ in pairs)
        ck_bytes = sum(a.numel() * a.element_size() for a, _, _ in pairs)
        del restored, saved[2], pairs
        _, rest, _ = train_run(torch, *base, "--steps", "2",
                               "--checkpoint-dir", tmp)
        check([s for s, *_ in rest] == [2, 3],
              f"resumed run logged steps {[s for s, *_ in rest]}")
        for (_, a, _, _), (_, b, _, _) in zip(first + rest, full):
            check(abs(a - b) <= TRAIN_RESUME_RTOL * abs(b),
                  f"loss {a} of the run with a checkpoint and its resume "
                  f"!= the uninterrupted run's {b} (rtol "
                  f"{TRAIN_RESUME_RTOL})")
    finally:
        ckpt.save_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)
    out["resume"] = {
        "uninterrupted": [x[1] for x in full], "first": [x[1] for x in first],
        "resumed": [x[1] for x in rest], "ckpt_bytes": ck_bytes,
        "ckpt_bf16_leaves": n_bf16, "run_with_saves_s": t_first,
        "load_s": t_load,
        "resumed_max_abs_diff": max(abs(a[1] - b[1])
                                    for a, b in zip(rest, full[2:]))}
    log(f"[train] {CUT_ARCH} (2 layers, S {CUT_S}, B {CUT_B}): 4 steps "
        f"uninterrupted {out['resume']['uninterrupted']}; 2 steps with a "
        f"step-2 checkpoint ({ck_bytes / 1e9:.2f} GB, {n_bf16} bf16 leaves; "
        f"the run with its saves {t_first:.2f} s, the load {t_load:.2f} s), "
        f"the restored params and opt state bit-equal to the saved ones; "
        f"resumed for 2: {out['resume']['resumed']} (max |diff| "
        f"{out['resume']['resumed_max_abs_diff']:.3e}, rtol "
        f"{TRAIN_RESUME_RTOL})")

    # ---- (c) variants, one step each
    for flag in (("--grad-compression", "bf16"), ("--microbatches", "2")):
        _, st, pk = train_run(torch, *base, "--steps", "1", *flag)
        out["variant " + " ".join(flag)] = st[0][1]
        log(f"[train] {CUT_ARCH} {' '.join(flag)}: loss {st[0][1]:.6f}, "
            f"grad_norm {st[0][2]:.6f}, {st[0][3]:.3f} s, peak "
            f"{pk / 1e9:.2f} GB")

    # ---- (d) the reduced configs, card vs CPU
    out["reduced_master_max_abs_diff"] = {
        name: train_card_vs_cpu(torch, name) for name in TRAIN_REDUCED}
    torch.cuda.empty_cache()
    return out


# ------------------------------------------ phase 5l: sharded training
#: qwen2-1.5b at full width cut to 8 layers, S 4096, global batch 2 on a
#: (data 2, model 1) mesh of two ranks on the card over gloo: each rank
#: trains one row a step; 2 steps from phase 5j's data seed
SHARD_LAYERS, SHARD_S, SHARD_B, SHARD_STEPS = 8, 4096, 2, 2
SHARD_RANKS = 2
#: seconds phase 5l waits for its ranks, and each collective's timeout
SHARD_DEADLINE_S = 600
SHARD_COLLECTIVE_TIMEOUT_S = 300
#: the train-step limits of PERF.md section 2: loss, grad norm, m and v
#: at atol 1e-5 / rtol 1e-4; params and master at 0.1 x the peak lr
SHARD_ATOL, SHARD_RTOL = 1e-5, 1e-4


def shard_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-1.5b").replace(n_layers=SHARD_LAYERS)


def shard_batches(torch, cfg):
    """Phase 5j's synthetic stream (seed 0) at S 4096, global batch 2."""
    from repro_torch.data.pipeline import DataConfig, make_source
    src = make_source(DataConfig(cfg.vocab_size, SHARD_S, SHARD_B, seed=0,
                                 kind="synthetic"))
    return [{"tokens": torch.from_numpy(src.batch_at(i)).to("cuda")}
            for i in range(SHARD_STEPS)]


def _nbytes(t):
    return t.numel() * t.element_size()


def shard_rank_train(torch, rank, out_dir):
    """One rank of phase 5l: the seeded full state sharded onto this rank
    (params by their specs, m, v and master by ZeRO-1), 2 sharded steps,
    then the state gathered in full; rank 0 writes it leaf by leaf under
    ``out_dir``. Returns what the parent checks, JSON-ready."""
    import math
    from repro_torch.common import tree
    from repro_torch.configs import ShapeConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import gather_state, shard_state
    cfg = shard_cfg()
    mesh = make_training_mesh(model=1)
    built = steps.build_train_step(cfg, ShapeConfig(
        "t", SHARD_S, SHARD_B, "train"), mesh)
    specs = {"params": built.in_specs[0], "opt": built.in_specs[1]}
    params = registry.init_params(cfg, 0, "cuda")
    state = shard_state({"params": params, "opt": opt.init_opt_state(params)},
                        specs, mesh)
    del params
    p, o = state["params"], state["opt"]
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = sum(_nbytes(t) for t in tree.leaves((p, o)))
    full_shape = {"params": built.args[0], "opt": built.args[1]}
    want = sum(
        math.prod(shd.local_shape(x.shape, s, mesh)) * x.element_size()
        for x, s in zip(tree.leaves(full_shape), _spec_leaves(specs)))
    allocated = torch.cuda.memory_allocated()
    batches = shard_batches(torch, cfg)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    mets, secs, sent = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sent.append(shd.CollectiveLog())
        with shd.recording(sent[-1]):
            p, o, m = built.fn(p, o, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    launched = all_kernel_launches(torch)
    full = gather_state({"params": p, "opt": o}, specs, mesh)
    leaves, paths = tree.flatten_with_paths(full)
    if rank == 0:
        for i, t in enumerate(leaves):
            torch.save(t.cpu(), Path(out_dir) / f"leaf{i:04d}.pt")
    # fp32 grads (accumulator dtype) and the loss, summed over data
    grad_bytes = 4 * sum(x.numel() for x in tree.leaves(built.args[0])) + 4
    return {"rank": rank, "coords": dict(mesh.coords),
            "mesh": dict(mesh.shape), "metrics": mets, "step_s": secs,
            "peak_bytes": peak, "resident_bytes": resident,
            "shard_bytes": want, "allocated_after_shard": allocated,
            "launched": launched, "grad_bytes_all_reduced": grad_bytes,
            "sent_by_kind": [x.by_kind for x in sent],
            "paths": paths, "checksum": [int(t.contiguous().view(
                {2: torch.int16, 4: torch.int32}[t.element_size()]).sum(
                    dtype=torch.int64)) for t in leaves],
            "route": shd.gather_route(mesh.groups["data"], "cuda")}


def _spec_leaves(specs):
    """The PartitionSpecs of a spec tree in JAX's leaf order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def shard_rank_main(argv):
    """``chip_smoke.py --shard-rank R --shard-store PATH --shard-out DIR``:
    one rank of phase 5l, joined to the gloo world of ``SHARD_RANKS``
    ranks through the FileStore at PATH, its result written as
    DIR/rankR.json (rank 0 also writes the gathered state there)."""
    import argparse
    import datetime
    ap = argparse.ArgumentParser()
    ap.add_argument("--shard-rank", type=int, required=True)
    ap.add_argument("--shard-store", required=True)
    ap.add_argument("--shard-out", required=True)
    a = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(a.shard_store, SHARD_RANKS),
        rank=a.shard_rank, world_size=SHARD_RANKS,
        timeout=datetime.timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        res = shard_rank_train(torch, a.shard_rank, a.shard_out)
    finally:
        dist.destroy_process_group()
    out = Path(a.shard_out) / f"rank{a.shard_rank}.json"
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(res))
    tmp.rename(out)
    return 0


def phase_sharded_train(torch, smi_line):
    """Sharded training (ROADMAP item 8b): two ranks on the one card in a
    gloo world at (data 2, model 1), each a subprocess of this script,
    train qwen2-1.5b at full width cut to 8 layers (bf16, remat as
    configured) 2 steps at S 4096, global batch 2, one row a rank, from
    phase 5j's seeds; then this process runs the unsharded step on the
    same batches with 2 microbatches (one rank's row each). The loss and
    grad norm of every step on both ranks, and the gathered params, m, v
    and master, agree with it within PERF.md section 2's train-step
    limits; each rank's resident state is its shards' size; no kernel is
    launched. A rank that fails, times out or exits non-zero fails the
    phase."""
    import shutil
    import tempfile
    from repro_torch.common import tree
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    tmp = Path(tempfile.mkdtemp(prefix="shard_smoke_"))
    procs, logs = [], []
    t_ranks = time.perf_counter()
    try:
        try:
            for r in range(SHARD_RANKS):
                logs.append(open(tmp / f"rank{r}.log", "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--shard-rank", str(r), "--shard-store",
                     str(tmp / "store"), "--shard-out", str(tmp)],
                    stdout=logs[-1], stderr=subprocess.STDOUT,
                    cwd=str(ROOT)))
            end = time.monotonic() + SHARD_DEADLINE_S
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(
                        timeout=max(1.0, end - time.monotonic())))
                except subprocess.TimeoutExpired:
                    codes.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        t_ranks = time.perf_counter() - t_ranks
        for r, code in enumerate(codes):
            tail = (tmp / f"rank{r}.log").read_text()[-3000:]
            check(code == 0, f"shard rank {r} "
                  + ("timed out" if code is None else f"exited {code}")
                  + f":\n{tail}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(SHARD_RANKS)]

        # the unsharded step in this process, one microbatch a row
        cfg = shard_cfg()
        params = registry.init_params(cfg, 0, "cuda")
        o = opt.init_opt_state(params)
        step = make_train_step(cfg, opt.OptConfig(),
                               num_microbatches=SHARD_B)
        with torch.inference_mode():   # the counters are inference tensors
            zero_launches()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_s = [], []
        for b in shard_batches(torch, cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, o, m = step(params, o, b)
            torch.cuda.synchronize()
            ref_s.append(time.perf_counter() - t0)
            ref.append({k: float(v) for k, v in m.items()})
        ref_peak = torch.cuda.max_memory_allocated()
        launched = all_kernel_launches(torch)
        check(not any(launched.values()), f"the unsharded step launched "
              f"kernels {launched}")
        for res in ranks:
            r = res["rank"]
            check(res["mesh"] == {"data": SHARD_RANKS, "model": 1}
                  and res["coords"] == {"data": r, "model": 0},
                  f"shard rank {r}: mesh {res['mesh']} at {res['coords']}")
            check(not any(res["launched"].values()), f"shard rank {r} "
                  f"launched kernels {res['launched']}")
            check(res["resident_bytes"] == res["shard_bytes"],
                  f"shard rank {r}: {res['resident_bytes']} B resident, its "
                  f"shards are {res['shard_bytes']} B")
            check(res["route"] == "broadcast", f"shard rank {r}: gather "
                  f"route {res['route']}, expected broadcast (gloo, CUDA)")
            check(all(k.get("all-reduce") == res["grad_bytes_all_reduced"]
                      for k in res["sent_by_kind"]),
                  f"shard rank {r}: all-reduce bytes sent a step "
                  f"{res['sent_by_kind']}, expected "
                  f"{res['grad_bytes_all_reduced']:,}")
            for i, (got, want) in enumerate(zip(res["metrics"], ref)):
                for k in ("loss", "grad_norm", "lr"):
                    check(abs(got[k] - want[k])
                          <= SHARD_ATOL + SHARD_RTOL * abs(want[k]),
                          f"shard rank {r} step {i}: {k} {got[k]} != the "
                          f"unsharded step's {want[k]}")
        check(ranks[0]["checksum"] == ranks[1]["checksum"],
              "the two ranks gathered different states")
        full = {"params": params, "opt": o}
        leaves, paths = tree.flatten_with_paths(full)
        check(paths == ranks[0]["paths"], "gathered state's leaves differ "
              "from the unsharded state's")
        p_atol = 0.1 * opt.OptConfig().peak_lr
        worst, n_bytes = {}, 0
        for i, (want, path) in enumerate(zip(leaves, paths)):
            got = torch.load(tmp / f"leaf{i:04d}.pt").to("cuda")
            n_bytes += _nbytes(got)
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"gathered {path}: {got.dtype} {tuple(got.shape)}")
            if got.dtype == torch.int32:
                check(torch.equal(got, want), f"gathered {path} differs")
                continue
            keys = path[2:-2].split("']['")
            part = keys[0] if keys[0] == "params" else keys[1]
            atol = p_atol if part in ("params", "master") else SHARD_ATOL
            d = (got.float() - want.float()).abs()
            lim = atol + SHARD_RTOL * want.float().abs()
            worst[part] = max(worst.get(part, 0.0), float(d.max()))
            check(bool((d <= lim).all()), f"gathered {path}: max |diff| "
                  f"{float(d.max()):.3e} beyond {atol:.1e} + "
                  f"{SHARD_RTOL} |x|")
            del got, d, lim
        del full, leaves, params, o
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ranks_wall_s": t_ranks, "step_s": {f"rank{x['rank']}":
                                               x["step_s"] for x in ranks},
           "unsharded_step_s": ref_s, "unsharded_peak_gb": ref_peak / 1e9,
           "peak_gb": {f"rank{x['rank']}": x["peak_bytes"] / 1e9
                       for x in ranks},
           "resident_gb": {f"rank{x['rank']}": x["resident_bytes"] / 1e9
                           for x in ranks},
           "grad_bytes_all_reduced_per_step":
               ranks[0]["grad_bytes_all_reduced"],
           "sent_by_kind_per_step": ranks[0]["sent_by_kind"],
           "resident_bytes": {f"rank{x['rank']}": x["resident_bytes"]
                              for x in ranks},
           "peak_bytes": {f"rank{x['rank']}": x["peak_bytes"]
                          for x in ranks},
           "losses": [x["loss"] for x in ranks[0]["metrics"]],
           "grad_norms": [x["grad_norm"] for x in ranks[0]["metrics"]],
           "unsharded_losses": [x["loss"] for x in ref],
           "max_abs_diff": worst, "gathered_bytes": n_bytes}
    for x in ranks:
        log(f"[shard] rank {x['rank']} of (data 2, model 1), qwen2-1.5b "
            f"full width cut to {SHARD_LAYERS} layers, S {SHARD_S}, one row "
            f"a step: step s {[round(t, 3) for t in x['step_s']]}, peak "
            f"memory {x['peak_bytes'] / 1e9:.2f} GB "
            f"(torch.cuda.max_memory_allocated), resident state "
            f"{x['resident_bytes'] / 1e9:.3f} GB (= its shards), gradient "
            f"bytes all-reduced per step {x['grad_bytes_all_reduced']:,}, "
            f"collective bytes sent a step by kind {x['sent_by_kind']}, "
            f"losses {[m['loss'] for m in x['metrics']]}; {smi_line}")
    log(f"[shard] unsharded step, 2 microbatches: step s "
        f"{[round(t, 3) for t in ref_s]}, peak {ref_peak / 1e9:.2f} GB, "
        f"losses {out['unsharded_losses']}; gathered state == unsharded "
        f"within the train-step limits, max |diff| {worst}; no kernel "
        f"launched; {smi_line}")
    return out


# ------------------------------------------------- phase 5m: the dry run
#: traced / measured peak memory the 5j and 5l cells must keep to
DRY_PEAK_RATIO = (0.5, 2.0)


def phase_dryrun(torch, trained, sharded, smi_line):
    """The dry run beside the card (ROADMAP item 11b): ``launch.dryrun``
    traces three cells on the host's CPU under ``FakeTensorMode`` (no
    card memory, no kernel): phase 5j's (qwen2-1.5b, S 4096, 8
    microbatches, one device), phase 5l's (8 layers, (data 2, model 1),
    one rank) and qwen2-1.5b train_4k on the 16x16 mesh (one rank). Each
    record is printed beside what 5j and 5l measured; the 5l cell's
    argument bytes (its state, and the global batch every rank takes)
    and all-reduce bytes must equal 5l's, and traced / measured peak lie
    within ``DRY_PEAK_RATIO`` for the 5j and 5l cells."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.distribution.sharding import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.hardware import H100_SXM
    qwen = get_config("qwen2-1.5b")
    cells = {
        "5j": (qwen, ShapeConfig("train_5j", TRAIN_S, TRAIN_B, "train"),
               None, 1),
        "5l": (shard_cfg(), ShapeConfig("train_5l", SHARD_S, SHARD_B,
                                        "train"),
               Mesh((("data", SHARD_RANKS), ("model", 1))), SHARD_RANKS),
        "train_4k 16x16": (qwen, SHAPES["train_4k"], make_production_mesh(),
                           256)}
    out = {}
    for key, (cfg, shape, mesh, n_dev) in cells.items():
        t0 = time.perf_counter()
        try:
            built, traced = dryrun.trace_cell(cfg, shape, mesh)
            rec = dryrun.record(cfg, shape, n_dev, built, traced)
        except Exception as e:  # noqa: BLE001 - a failed cell fails the phase
            raise SmokeError(f"dry run of the {key} cell failed: "
                             f"{type(e).__name__}: {e}") from e
        rec["trace_s"] = time.perf_counter() - t0
        r, m = rec["roofline"], rec["memory"]
        check(r["hw"] == H100_SXM.name, f"{key}: priced on {r['hw']}")
        out[key] = rec
        log(f"[dry] {key} cell traced in {rec['trace_s']:.1f} s "
            f"({built.meta['num_microbatches']} microbatches, {n_dev} "
            f"device(s)): FLOPs {r['flops']:.4e} (FlopCounterMode "
            f"{r['torch_flops']:.4e}), bytes {r['bytes_accessed']:.4e}, "
            f"collective bytes by kind {r['coll_by_kind']}, argument "
            f"{m['argument_bytes']:,} B, peak {m['peak_bytes']:,} B; "
            f"analyze(hw=H100_SXM): compute {r['compute_t']:.4f} s, memory "
            f"{r['memory_t']:.4f} s, collective {r['collective_t']:.4f} s, "
            f"bottleneck {r['bottleneck']}, useful_ratio "
            f"{r['useful_ratio']:.4f}")
    j, sl = out["5j"], out["5l"]
    batch = SHARD_B * SHARD_S * 4           # int32 tokens, taken whole
    resident = sharded["resident_bytes"]["rank0"]
    check(sl["memory"]["argument_bytes"] == resident + batch,
          f"5l cell: traced argument bytes {sl['memory']['argument_bytes']:,}"
          f" != 5l's resident {resident:,} + the batch {batch:,}")
    sent = sharded["sent_by_kind_per_step"][0].get("all-reduce")
    traced_ar = sl["roofline"]["coll_by_kind"].get("all-reduce")
    check(traced_ar == sent == sharded["grad_bytes_all_reduced_per_step"],
          f"5l cell: traced all-reduce bytes {traced_ar} != sent {sent}")
    ratios = {
        "5j": j["memory"]["peak_bytes"] / (trained["full"]["peak_mem_gb"]
                                           * 1e9),
        "5l": sl["memory"]["peak_bytes"] / max(sharded["peak_bytes"].values())}
    for key, ratio in ratios.items():
        check(DRY_PEAK_RATIO[0] <= ratio <= DRY_PEAK_RATIO[1],
              f"{key} cell: traced / measured peak {ratio:.3f} outside "
              f"{DRY_PEAK_RATIO}")
    steady = trained["full"]["steady_step_s"]
    log(f"[dry] beside the card: 5j measured a steady step of {steady:.3f} s "
        f"and a peak of {trained['full']['peak_mem_gb'] * 1e9:,.0f} B "
        f"(traced / measured peak {ratios['5j']:.4f}); roofline times "
        f"compute {j['roofline']['compute_t']:.4f} s, memory "
        f"{j['roofline']['memory_t']:.4f} s, collective "
        f"{j['roofline']['collective_t']:.4f} s. 5l measured {resident:,} B "
        f"resident a rank (traced arguments {sl['memory']['argument_bytes']:,}"
        f" B = it + the {batch:,} B batch), {sent:,} all-reduce bytes sent a "
        f"step (traced {traced_ar:,.0f}), peak "
        f"{max(sharded['peak_bytes'].values()):,} B (traced / measured "
        f"{ratios['5l']:.4f}); {smi_line}")
    return {k: {"memory": v["memory"], "trace_s": v["trace_s"],
                "flops": v["roofline"]["flops"],
                "torch_flops": v["roofline"]["torch_flops"],
                "bytes": v["roofline"]["bytes_accessed"],
                "coll_by_kind": v["roofline"]["coll_by_kind"],
                "compute_t": v["roofline"]["compute_t"],
                "memory_t": v["roofline"]["memory_t"],
                "collective_t": v["roofline"]["collective_t"],
                "useful_ratio": v["roofline"]["useful_ratio"],
                "fits_hbm": v["fits_hbm"]} for k, v in out.items()} | {
        "peak_ratio_traced_over_measured": ratios,
        "measured_5j_steady_step_s": steady}


# ------------------------------------------------ phase 5n: the examples
EXAMPLES = ROOT / "examples_torch"
#: the examples' training steps (their default: the reference scripts')
EXAMPLE_TRAIN_STEPS = 300
#: train_lm's steps (the launcher's reduced qwen2-1.5b)
EXAMPLE_LM_STEPS = 20
#: the sweep's rows recomputed on the CPU: its densest and sparsest
SWEEP_CHECKED = ((-0.5, 0), (0.6, 15))
#: the net sparsity's largest difference card vs CPU on the same Q/K/V
SWEEP_TOL = 1e-6


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_example(name, *argv):
    """``examples_torch/<name>.py`` run in this process as ``__main__``
    with ``argv``: (its globals, or None after a ``sys.exit(0)``, and
    what it printed). A non-zero exit fails the phase."""
    import contextlib
    import runpy
    path = EXAMPLES / f"{name}.py"
    old = sys.argv
    sys.argv = [str(path), *argv]
    tee = _Tee(sys.stdout)
    g = None
    try:
        with contextlib.redirect_stdout(tee):
            g = runpy.run_path(str(path), run_name="__main__")
    except SystemExit as e:
        check(not e.code, f"examples_torch/{name}.py {argv} exited {e.code}")
    finally:
        sys.argv = old
    return g, "".join(tee.parts)


def _quickstart(torch):
    """quickstart.py on the card: section 3 launches the scout (tensor-core
    path) and the block kernel (tile path, fp32 V) once each, and nothing
    else launches; both are held against their plain versions at the
    recorded inputs (scout bit-equal), and section 3's output and stats
    against the pipeline's plain versions on the same inputs."""
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.hdp_scout import hdp_scout
    rec = {"scout": Recorder(hdp_scout),
           "block": Recorder(hdp_block_sparse_attention)}
    ops.hdp_scout, ops.hdp_block_sparse_attention = rec["scout"], rec["block"]
    with torch.inference_mode():
        zero_launches()
    try:
        g, out = run_example("quickstart", "--device", "cuda")
    finally:
        ops.hdp_scout = hdp_scout
        ops.hdp_block_sparse_attention = hdp_block_sparse_attention
    with torch.inference_mode():
        launched = {f.__name__: dict(f.launches_by_path) for f in (
            hdp_scout, hdp_block_sparse_attention, flash_attention,
            hdp_paged_fum_decode)}
        block_runs = hdp_block_sparse_attention.runs.read()
    want = {"hdp_scout": {"tensor_core": 1, "dp4a": 0},
            "hdp_block_sparse_attention": {"tensor_core": 0, "tile": 1},
            "flash_attention": {"tensor_core": 0, "tile": 0},
            "hdp_paged_fum_decode": {"split": 0, "single": 0}}
    check(launched == want and block_runs == 1,
          f"quickstart: launches {launched} and {block_runs} block tile "
          f"runs on the card, expected {want} and 1")
    check(out.rstrip().endswith("quickstart OK"),
          "quickstart did not print 'quickstart OK'")
    (iq, ik), kw = rec["scout"].best
    check_scout(torch, "hdp_scout at quickstart's section 3", iq, ik,
                path="tensor_core", **kw)
    args, kw = rec["block"].best
    c = dict(zip(("q", "k", "v", "kv_idx", "counts", "head_kept"), args),
             **{"kv_len": None, "score_scale": None, **kw})
    check_block(torch, "hdp_block_sparse_attention at quickstart's section "
                "3", c, poison=False, path="tile")
    # section 3 end to end against the plain versions on the CPU
    cpu = [g[n].cpu() for n in ("q", "k", "v")]
    p_out, p_st = ops.hdp_attention_tpu(*cpu, g["kcfg"], return_stats=True)
    o, st = g["out_k"].cpu(), g["st"]
    err = (o - p_out).abs().max().item()
    check(torch.allclose(o, p_out, atol=ATOL, rtol=RTOL),
          f"quickstart section 3: card vs plain max |err| {err:.3e}")
    check(torch.equal(st["theta_head"].cpu(), p_st["theta_head"])
          and all(float(st[k]) == float(p_st[k]) for k in (
              "block_sparsity", "head_sparsity", "kept_blocks_per_row")),
          f"quickstart section 3: stats differ from the plain versions' "
          f"{ {k: (float(st[k]), float(p_st[k])) for k in ('block_sparsity', 'head_sparsity', 'kept_blocks_per_row')} }")
    log(f"[examples] quickstart: scout 1 launch on the tensor-core path, "
        f"block 1 on the tile path (1 run on the card), section 3 vs the "
        f"plain pipeline max |err| {err:.3e}, theta_head bit-equal, block "
        f"sparsity {float(st['block_sparsity']):.4f}")
    return {"launches": {"hdp_scout": 1, "hdp_block_sparse_attention": 1},
            "section3_max_abs_err": err}


def _loss_line(out, scale):
    """(first, last) loss of ``train_model``'s summary line."""
    import re
    m = re.search(rf"\[{scale}\] trained (\d+) steps in \S+ loss "
                  r"([\d.]+) -> ([\d.]+)", out)
    check(m is not None and int(m.group(1)) == EXAMPLE_TRAIN_STEPS,
          f"bench-{scale} was not trained for {EXAMPLE_TRAIN_STEPS} steps "
          f"on the card")
    return float(m.group(2)), float(m.group(3))


def _sweep_point(g, th, rho, pct):
    """The sweep's HDPConfig at (rho, pct) of the theta_head samples
    ``th``, and its tau."""
    import numpy as np
    tau = float(np.percentile(th, pct)) if pct else -1.0
    return g["base"].replace(rho_b=rho, tau_h=tau), tau


def _masks(caps, hdp):
    """Each layer's (keep blocks, head gates), moved to the CPU, and the
    mean net sparsity, of ``hdp_attention`` on the captured Q/K/V (on
    their device)."""
    import numpy as np
    from repro_torch.core.hdp import hdp_attention
    masks, nets = [], []
    for c in caps:
        st = hdp_attention(c["q"], c["k"], c["v"], hdp)[1]
        masks.append((st.keep_blocks.cpu(), st.head_kept.cpu()))
        nets.append(float(st.net_sparsity))
    return masks, float(np.mean(nets))


def _mask_diff(a, b):
    """(entries that differ, entries) of two layers' mask lists."""
    n = diff = 0
    for (ka, ha), (kb, hb) in zip(a, b):
        n += ka.numel() + ha.numel()
        diff += int((ka != kb).sum()) + int((ha != hb).sum())
    return diff, n


def _int_parts_differ(caps_a, caps_b, hdp):
    """How many integer parts of the scout's Q and K (the fixed-point
    split it prunes on) differ between two captures of the same tokens."""
    from repro_torch.core.hdp import calibrated_split
    n = 0
    for a, b in zip(caps_a, caps_b):
        for key in ("q", "k"):
            ia = calibrated_split(a[key].cpu(), hdp)[2]
            ib = calibrated_split(b[key].cpu(), hdp)[2]
            n += int((ia != ib).sum())
    return n


def _pruning_sweep(torch, common):
    """pruning_sweep.py on the card (bench-tiny trained there from
    scratch), its densest and sparsest rows recomputed on the CPU. On
    the card's own Q/K/V (captured on the card, moved to the CPU), keep
    masks and head gates equal and net sparsity within SWEEP_TOL. From
    the card's weights (a CPU forward): agreement equal, and a keep mask
    may differ only where the CPU's Q or K rounds to another integer
    part than the card's (fp32 sums in another order: a value within a
    few ulps of an integer), which is counted and printed; each token
    that differs is printed with its top-2 margin."""
    from repro_torch.common import tree
    from repro_torch.core.hdp import hdp_attention
    g, out = run_example("pruning_sweep", "--device", "cuda")
    first, last = _loss_line(out, "tiny")
    check(last < first, f"bench-tiny's loss did not fall: {first} -> {last}")
    rows = [ln.split() for ln in out.splitlines()
            if len(ln.split()) == 4 and ln.split()[1].isdigit()]
    check(len(rows) == 8, f"the sweep printed {len(rows)} rows, not 8")
    cfg, batches = g["cfg"], g["batches"]
    cpu_params = tree.tree_map(lambda t: t.cpu(), g["params"])
    cpu_th = common.theta_head_samples(cfg, cpu_params, batches,
                                       g["base"].replace(block_pruning=False))
    caps_card = common.capture_qkv(cfg, g["params"], batches[0])
    caps_moved = [{k: t.cpu() for k, t in c.items()} for c in caps_card]
    caps_cpu = common.capture_qkv(cfg, cpu_params, batches[0])
    out_rows = {}
    for rho, pct in SWEEP_CHECKED:
        hdp, tau = _sweep_point(g, g["th"], rho, pct)
        hdp_cpu, tau_cpu = _sweep_point(g, cpu_th, rho, pct)
        printed = next(r for r in rows if float(r[0]) == rho
                       and int(r[1]) == pct)
        label = f"sweep rho {rho} pct {pct}"
        # the card's own inputs on both devices
        card, net = _masks(caps_card, hdp)
        same, net_same = _masks(caps_moved, hdp)
        diff, n = _mask_diff(card, same)
        check(diff == 0 and abs(net - net_same) <= SWEEP_TOL,
              f"{label}: on the card's Q/K/V the CPU's keep masks differ "
              f"in {diff} of {n} entries, net {net_same} vs the card's {net}")
        # from the card's weights: the CPU's own forward
        attn_card = lambda li, q, k, v: hdp_attention(q, k, v, hdp)[0]  # noqa: E731
        attn_cpu = lambda li, q, k, v: hdp_attention(q, k, v, hdp_cpu)[0]  # noqa: E731
        ag = common.agreement_with(cfg, g["params"], attn_card, batches)
        ag_cpu = common.agreement_with(cfg, cpu_params, attn_cpu, batches)
        own, net_own = _masks(caps_cpu, hdp_cpu)
        diff_own, _ = _mask_diff(card, own)
        n_int = _int_parts_differ(caps_card, caps_cpu, hdp)
        logits = common.forward_with_attention(cfg, g["params"], batches[0],
                                               attn_card).cpu()
        logits_cpu = common.forward_with_attention(cfg, cpu_params,
                                                   batches[0], attn_cpu)
        tok, tok_cpu = logits.argmax(-1), logits_cpu.argmax(-1)
        for b, i in (tok != tok_cpu).nonzero().tolist():
            top2 = logits_cpu[b, i].topk(2).values
            log(f"[examples] {label}: token at ({b}, {i}) card "
                f"{int(tok[b, i])} CPU {int(tok_cpu[b, i])}, CPU top-2 "
                f"margin {float(top2[0] - top2[1]):.3e}")
        check(ag == ag_cpu and (diff_own == 0 or n_int > 0),
              f"{label}: from the card's weights, agreement {ag} (card) vs "
              f"{ag_cpu} (CPU); keep masks differ in {diff_own} entries with "
              f"{n_int} integer parts of Q/K differing")
        check(f"{net:.3f}" == printed[2] and f"{ag:.3f}" == printed[3],
              f"{label}: recomputed {net:.3f} {ag:.3f}, printed {printed[2:]}")
        out_rows[f"rho {rho} pct {pct}"] = {
            "tau_card": tau, "tau_cpu": tau_cpu, "net": net,
            "net_cpu_forward": net_own, "agreement": ag,
            "mask_entries": n, "mask_entries_differing_cpu_forward": diff_own,
            "int_parts_differing_cpu_forward": n_int}
        log(f"[examples] {label}: on the card's Q/K/V the CPU's keep masks "
            f"equal the card's ({n} entries), net {net_same:.6f} (card "
            f"{net:.6f}); from the card's weights on the CPU: agreement "
            f"{ag_cpu:.6f} (card {ag:.6f}), keep masks differ in "
            f"{diff_own} of {n} entries (net {net_own:.6f}), {n_int} integer "
            f"parts of the scout's Q/K differ, tau {tau_cpu:.6g} (card "
            f"{tau:.6g})")
    return {"loss": [first, last], "rows": rows, "checked": out_rows}


def _serve_hdp(torch, common, scale, smi_line):
    """serve_hdp.py on the card at ``scale``: the HDP serve's decode on
    the FUM kernel, its runs on the card = layers x (decode steps +
    warm-up); both serves' tokens equal the same serves on the CPU from
    the card's weights."""
    from repro_torch.attention import AttnSpec
    from repro_torch.common import tree
    from repro_torch.serving import Engine, Request
    with torch.inference_mode():
        zero_launches()
    g, out = run_example("serve_hdp", "--device", "cuda", "--scale", scale)
    with torch.inference_mode():
        launches, runs = kernel_counts(torch)
    cfg, s = g["cfg"], g["s_hdp"]
    label = f"serve_hdp bench-{scale} HDP (paged, ps {s['page_size']})"
    check(s["attn_backend_decode"] == "pallas_paged_decode"
          and s["page_size"] == 2,
          f"{label}: decode on {s['attn_backend_decode']}, page size "
          f"{s['page_size']}")
    check_decode_launches(s, launches, "fum", label, runs,
                          n_layers=cfg.n_layers)
    cpu_params = tree.tree_map(lambda t: t.cpu(), g["params"])
    for run, with_hdp, layout in (("hdp", True, "paged"),
                                  ("dense", False, "dense")):
        c = cfg.replace(hdp=g["hdp"]) if with_hdp else cfg
        eng = Engine(c, params=cpu_params, device="cpu", max_batch=4,
                     max_len=96, prefill_buckets=(16, 32, 64),
                     collect_stats=with_hdp, attn=AttnSpec(layout=layout))
        for uid, p in enumerate(g["prompts"]):
            eng.submit(Request(uid, p, max_new_tokens=g["args"].max_new))
        host = {u: r.tokens for u, r in eng.run().items()}
        card = {u: r.tokens for u, r in g[f"res_{run}"].items()}
        check(card == host, f"serve_hdp bench-{scale} {run}: card tokens "
              f"differ from the CPU's in uids "
              f"{[u for u in card if card[u] != host.get(u)]}")
    summary = {k: s[k] for k in (
        "decode_tok_s", "block_sparsity", "head_sparsity", "page_sparsity",
        "cache_bytes", "decode_steps", "graph_captures")}
    summary.update(fum_runs=runs["fum"], fum_by_path=launches["fum"],
                   dense_decode_tok_s=g["s_dense"]["decode_tok_s"],
                   dense_cache_bytes=g["s_dense"]["cache_bytes"],
                   agreement=float(g["agree"]))
    log(f"[examples] serve_hdp bench-{scale}: {json.dumps(summary)}; card "
        f"tokens == CPU tokens (HDP and dense serves); {smi_line}")
    return summary


def phase_examples(torch, smi_line):
    """The examples (ROADMAP item 12), outside inference mode (they
    train): ``examples_torch/`` run in this process through ``runpy``,
    ``common.CACHE_DIR`` a fresh temporary directory, so every model is
    trained on the card. quickstart; train_lm (20 steps into a temporary
    checkpoint directory); pruning_sweep (bench-tiny, 300 steps); serve_hdp
    at bench-tiny (the sweep's model) and bench-base (300 steps)."""
    import shutil
    import tempfile
    sys.path.insert(0, str(ROOT))
    from examples_torch import common
    tmp = tempfile.mkdtemp(prefix="examples_5n_")
    old_cache = common.CACHE_DIR
    common.CACHE_DIR = str(Path(tmp) / "cache")
    out = {}
    try:
        out["quickstart"] = _quickstart(torch)
        with torch.inference_mode():
            zero_launches()
        run_example("train_lm", "--device", "cuda", "--steps",
                    str(EXAMPLE_LM_STEPS), "--checkpoint-dir",
                    str(Path(tmp) / "train_lm"))
        launched = all_kernel_launches(torch)
        check(not any(launched.values()),
              f"train_lm launched kernels {launched}")
        log(f"[examples] train_lm: {EXAMPLE_LM_STEPS} steps, exit 0")
        out["pruning_sweep"] = _pruning_sweep(torch, common)
        for scale in ("tiny", "base"):
            out[f"serve_hdp {scale}"] = _serve_hdp(torch, common, scale,
                                                   smi_line)
    finally:
        common.CACHE_DIR = old_cache
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_timing_zamba2(torch, calls):
    """The scout, block and flash kernels, each on its path in
    ``ZAMBA_PATHS``, at zamba2-7b's aligned prefill's own inputs (B 1,
    32 heads, S 4096, hd 112, bf16 V): kernel, plain version, bound, and
    flash beside bf16 ``scaled_dot_product_attention`` at the same
    inputs; the scout's dp4a kernel too ("hdp_scout[dp4a]"). Returns
    {kernel: (kernel ms, plain ms, bound ms, bound by, bytes, ops,
    library ms)}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         hdp_block_sparse_attention_plain,
                                         hdp_scout_plain)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    (iq, ik), kw = calls["scout"]
    res = {"hdp_scout": (
        time_ms(torch, lambda: hdp_scout(iq, ik, **kw), 20, flush),
        time_ms(torch, lambda: hdp_scout_plain(iq, ik, **kw), 3, flush),
        *scout_bound(torch, iq, ik, kw), None)}
    # the dp4a kernel, the earlier path at this shape, at the same inputs
    res["hdp_scout[dp4a]"] = (
        time_ms(torch, lambda: hdp_scout(iq, ik, path="dp4a", **kw), 20,
                flush), *res["hdp_scout"][1:])
    args, kw = calls["block"]
    res["hdp_block_sparse_attention"] = (
        time_ms(torch, lambda: hdp_block_sparse_attention(*args, **kw), 10,
                flush),
        time_ms(torch, lambda: hdp_block_sparse_attention_plain(
            *args, **kw), 3, flush),
        *block_bound(torch, args, kw), None)
    (q, k, v), kw = calls["flash"]
    res["flash_attention"] = (
        time_ms(torch, lambda: flash_attention(q, k, v, **kw), 10, flush),
        time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), 3,
                flush),
        *flash_bound(torch, q, k, v, kw["causal"]),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kw["causal"]), 20, flush))
    for name, (k_ms, p_ms, bound, by, nbytes, ops, lib) in res.items():
        log(f"[timing] {name} [{ZAMBA_PATHS.get(name, 'dp4a')}] at "
            f"zamba2-7b's aligned prefill (B1 H32 S{PREFILL_S} hd112): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.6f} "
            f"ms ({by}: {nbytes} B, {ops:.4g} ops)"
            + (f", scaled_dot_product_attention (bf16) {lib:.4f} ms"
               if lib is not None else ""))
    return res


# ------------------------------------------------------------ phase 6
def time_ms(torch, fn, iters, flush):
    """Median device time of fn over `iters` runs, L2 flushed before each
    (the decode finds a layer's pages cold: 28 layers of pool exceed L2).
    The host enqueues each run behind a ~1 ms device spin, so the events
    bracket the run's device work and not the host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def fum_bound(torch, c):
    """Least time for the work this input needs: the K/V bytes of every
    (row, head, page) some query row keeps plus the small inputs and the
    output, against the flops of the scores and p.V of kept rows, priced
    as the block kernel's bound prices them: qq.K and frac(qq).frac(K)
    take operands on the Q4.12 grid or int8 codes, which split exactly
    into bf16 limbs (the bf16 tensor rate); p.V is at the bf16 rate
    where p is rounded to bf16 (a bf16 pool) and at the fp32 rate
    otherwise (p stays fp32 against the dequantized V)."""
    B, N, G, Sq, hd = c["qq"].shape
    ps = c["k_pool"].shape[1]
    item = c["k_pool"].element_size()
    counts = c["counts"].cpu()
    keep = c["keep"].cpu().bool()                   # [B,mk,N,G,Sq]
    mk = keep.shape[1]
    listed = torch.arange(mk)[None, :] < counts[:, None]        # [B,mk]
    head_page = keep.flatten(3).any(-1) & listed[:, :, None]    # [B,mk,N]
    kept_rows = int((keep & listed[:, :, None, None, None]).sum())
    nbytes = int(head_page.sum()) * ps * hd * 2 * item
    if c["k_scale"] is not None:
        nbytes += int(head_page.sum()) * 2 * 4
    for name in ("qq", "page_ids", "logical", "counts", "keep", "kv_len"):
        nbytes += c[name].numel() * c[name].element_size()
    nbytes += c["qq"].numel() * 4                            # output
    score_flops = kept_rows * ps * 4 * hd   # qk, fq.fk: 2 flops per MAC
    pv_flops = kept_rows * ps * 2 * hd
    pv_peak = BF16_FLOP_S if c["v_pool"].dtype == torch.bfloat16 \
        else FP32_FLOP_S
    flops = score_flops + pv_flops
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = score_flops / BF16_FLOP_S + pv_flops / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def fum_variant(torch, c, fmt):
    """The timing case's pools in another format, holding the same
    values where the format can: fp8 V pages (scale 1.0) of the decoded
    V, or the decoded K and V in bf16 (exact: codes x 2^-3)."""
    from repro_torch.core.quant import decode_pool, to_fp8_e4m3
    k = decode_pool(c["k_pool"], c["k_scale"][:, None, :, None])
    v = decode_pool(c["v_pool"], c["v_scale"][:, None, :, None])
    if fmt == "fp8_v":
        return dict(c, v_pool=to_fp8_e4m3(v),
                    v_scale=torch.ones_like(c["v_scale"]), fmt=fmt)
    return dict(c, k_pool=k.to(torch.bfloat16), v_pool=v.to(torch.bfloat16),
                k_scale=None, v_scale=None, fmt=fmt)


def phase_timing(torch, c, olmoe_case, tp_case):
    """The FUM decode at the timing case, split across blocks
    (``fum_splits``' S) and in one pass (S = 1), in turns with the plain
    version; then at the verify shape (Sq 4 and 8, the same widths and
    page density); then the fp8-V and bf16 pool variants at the timing
    case, split; then at olmoe-1b-7b's decode shape (G 1) at the rule's
    S and in one pass, and at one rank's shard of qwen2's at tp 2 (N 1).
    Returns {mode, "verify<Sq>", format, "olmoe", "olmoe_single" or
    "tp2": (kernel ms, plain ms, bound ms, bound by)}."""
    from repro_torch.kernels.hdp_paged_decode import (fum_splits,
                                                      hdp_paged_fum_decode)
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    args, kws = kernel_args(c)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    bound, bound_by, nbytes, flops = fum_bound(torch, c)
    B, N, G = c["qq"].shape[:3]
    S = fum_splits(B, N, c["page_ids"].shape[1],
                   torch.cuda.get_device_properties(0).multi_processor_count,
                   G)
    p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws), 5,
                   flush)
    res = {}
    for mode, splits in (("split", None), ("single", 1)):
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(
            *args, **kws, splits=splits), 50, flush)
        res[mode] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [{mode}, S={splits or S}] at B8 "
            f"N2 G6 Sq1 hd128 ps128 (pages listed per row "
            f"{c['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
            f"{flops} flop)")
    for Sq in (4, 8):
        # the verify shape: the timing case's widths at Sq query rows
        cv = to_dev(make_case(torch, B=8, N=2, G=6, Sq=Sq, hd=128, ps=128,
                              nP=16, fmt="int8", live=0.5, seed=7), "cuda")
        args, kws = kernel_args(cv)
        bound, bound_by, nbytes, flops = fum_bound(torch, cv)
        p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws),
                       5, flush)
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                       flush)
        res[f"verify{Sq}"] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [verify, Sq={Sq}, split, S={S}] "
            f"at B8 N2 G6 hd128 ps128 (pages listed per row "
            f"{cv['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
            f"{flops} flop)")
    for fmt in ("fp8_v", "bf16"):
        cv = fum_variant(torch, c, fmt)
        args, kws = kernel_args(cv)
        bound, bound_by, nbytes, flops = fum_bound(torch, cv)
        p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws),
                       5, flush)
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                       flush)
        res[fmt] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [{fmt} pool, split, S={S}] at "
            f"the same case: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {bound:.6f} ms ({bound_by}: {nbytes} B, {flops} flop)")
    args, kws = kernel_args(olmoe_case)
    bound, bound_by, nbytes, flops = fum_bound(torch, olmoe_case)
    S = fum_splits(*olmoe_case["qq"].shape[:2],
                   olmoe_case["page_ids"].shape[1],
                   torch.cuda.get_device_properties(0).multi_processor_count,
                   olmoe_case["qq"].shape[2])
    p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws), 5,
                   flush)
    # the rule's S, and one pass beside it (each in turns with the other)
    for key, splits in (("olmoe", None), ("olmoe_single", 1)):
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(
            *args, **kws, splits=splits), 50, flush)
        res[key] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [olmoe-1b-7b, S={splits or S}] "
            f"at B8 N16 G1 Sq1 hd128 ps128 (pages listed per row "
            f"{olmoe_case['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
            f"{flops} flop)")
    args, kws = kernel_args(tp_case)
    bound, bound_by, nbytes, flops = fum_bound(torch, tp_case)
    S = fum_splits(8, 1, tp_case["page_ids"].shape[1],
                   torch.cuda.get_device_properties(0).multi_processor_count,
                   6)
    p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws), 5,
                   flush)
    k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                   flush)
    res["tp2"] = (k_ms, p_ms, bound, bound_by)
    log(f"[timing] hdp_paged_fum_decode [qwen2-1.5b tp 2 shard, S={S}] at "
        f"B8 N1 G6 Sq1 hd128 ps128 (pages listed per row "
        f"{tp_case['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
        f"{flops} flop)")
    return res


def scout_bound(torch, iq, ik, kw):
    """Least time for the scout's work on these inputs: IQ and IK read
    once, theta and keep written once, against one int8 multiply-add per
    (valid row, valid col, d) at the card's int8 rate."""
    B, H, Sq, hd = iq.shape
    Sk = ik.shape[2]
    nq, nk = -(-Sq // kw["block_q"]), -(-Sk // kw["block_k"])
    rows = torch.arange(Sq, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=Sk).sum()) if kw["causal"] \
        else float(Sq * Sk)
    nbytes = (iq.numel() + ik.numel()) * 4 + B * H * nq * nk * 5 + B * H * 4
    ops = B * H * pairs * hd * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def block_bound(torch, args, kw):
    """Least time for the block kernel's work on these inputs: the valid
    (row, col) pairs of every listed block of a kept head, 2 flops per
    pair and d for each product, against Q read once, every listed K/V
    block read once and the output written. q.k and fq.fk take operands
    on the Q4.12 grid, which split exactly into bf16 limbs: the bf16
    tensor rate. p.v has V's type, since p is rounded to it (bf16 V: the
    bf16 tensor rate; fp32 V: the fp32 rate)."""
    q, k, v, idx, cnt, hk = args
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    bq, bk = kw["block_q"], kw["block_k"]
    nq, mk = idx.shape[2], idx.shape[3]
    live = (torch.arange(mk, device=idx.device) < cnt[..., None]) \
        & hk[..., None, None].bool()
    ent = torch.nonzero(live)                           # [E, 4] b,h,i,j
    blk = idx[ent[:, 0], ent[:, 1], ent[:, 2], ent[:, 3]].long()
    row = ent[:, 2:3] * bq + torch.arange(bq, device=idx.device)   # [E,bq]
    c_lo = (blk * bk)[:, None]
    c_hi = torch.clamp((blk + 1) * bk, max=Sk)[:, None]
    if kw.get("kv_len") is not None:
        lens = kw["kv_len"][ent[:, 0], ent[:, 1]].long()[:, None]
        c_hi = torch.minimum(c_hi, lens)
    hi = torch.minimum(c_hi, row + 1) if kw.get("causal", True) else \
        c_hi.expand_as(row)
    pairs = float(torch.where(row < Sq, torch.clamp(hi - c_lo, min=0),
                              0).sum())
    score_flops = pairs * hd * (4 if kw.get("approx", True) else 2)
    pv_flops = pairs * hd * 2
    pv_peak = BF16_FLOP_S if v.dtype == torch.bfloat16 else FP32_FLOP_S
    flops = score_flops + pv_flops
    listed = torch.zeros(B, H, -(-Sk // bk), dtype=torch.bool,
                         device=idx.device)
    listed[ent[:, 0], ent[:, 1], blk] = True
    nbytes = q.numel() * 4 * 2 + int(listed.sum()) * bk * hd * (
        k.element_size() + v.element_size()) \
        + (idx.numel() + cnt.numel() + hk.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = score_flops / BF16_FLOP_S + pv_flops / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_bound(torch, q, k, v, causal):
    """Least time for flash on these inputs: q, k, v read once and the
    output written, against 4 flops per valid (row, col) pair and d
    (q.k and p.v) at the bf16 tensor-core rate (fp32 inputs: the fp32
    rate)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    rows = torch.arange(Sq, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=Sk).sum()) if causal \
        else float(Sq * Sk)
    flops = B * H * pairs * hd * 4
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_FLOP_S if q.dtype == torch.bfloat16 else FP32_FLOP_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_timing_prefill(torch, calls, block_tile_call):
    """The scout, block and flash kernels at the aligned prefill's own
    inputs (block and flash on the tensor-core path): kernel, plain
    version, bound and (flash) the PyTorch SDPA call as a yardstick; the
    tile paths at the decode route's block call and at the prefill's
    flash inputs in fp32. Returns {entry name: (kernel ms, plain ms,
    bound ms, bound by, bytes, ops, library ms)}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         hdp_block_sparse_attention_plain,
                                         hdp_scout_plain)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    res = {}
    (iq, ik), kw = calls["scout"]
    scout_plain_ms = time_ms(torch, lambda: hdp_scout_plain(iq, ik, **kw), 3,
                             flush)
    for name, path in (("hdp_scout", None), ("hdp_scout[dp4a]", "dp4a")):
        res[name] = (
            time_ms(torch, lambda: hdp_scout(iq, ik, path=path, **kw), 20,
                    flush),
            scout_plain_ms, *scout_bound(torch, iq, ik, kw), None)
    for name, (args, kw) in (("hdp_block_sparse_attention", calls["block"]),
                             ("hdp_block_sparse_attention[tile]",
                              block_tile_call)):
        res[name] = (
            time_ms(torch, lambda: hdp_block_sparse_attention(*args, **kw),
                    10, flush),
            time_ms(torch, lambda: hdp_block_sparse_attention_plain(
                *args, **kw), 3, flush),
            *block_bound(torch, args, kw), None)
    (q, k, v), kw = calls["flash"]
    for name, dt in (("flash_attention", q.dtype),
                     ("flash_attention[tile]", torch.float32)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        res[name] = (
            time_ms(torch, lambda: flash_attention(qd, kd, vd, **kw), 10,
                    flush),
            time_ms(torch, lambda: flash_attention_plain(qd, kd, vd, **kw), 3,
                    flush),
            *flash_bound(torch, qd, kd, vd, kw["causal"]),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                qd, kd, vd, is_causal=kw["causal"]), 20, flush))
    for name, (k_ms, p_ms, bound, by, nbytes, ops, lib) in res.items():
        where = ("the decode route's call" if name ==
                 "hdp_block_sparse_attention[tile]" else
                 "the aligned prefill's inputs")
        log(f"[timing] {name} at {where}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.6f} ms "
            f"({by}: {nbytes} B, {ops:.4g} ops)"
            + (f", scaled_dot_product_attention {lib:.4f} ms"
               if lib is not None else ""))
    return res


# ------------------------------------------------------------------ main
def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL: the port's package is missing ({SRC / 'repro_torch'});"
              " run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global HBM_BYTES_S, BF16_FLOP_S
    from repro_torch.roofline.hardware import H100_SXM
    HBM_BYTES_S, BF16_FLOP_S = H100_SXM.hbm_bw, H100_SXM.peak_flops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[phase] = round(time.perf_counter() - t0, 1)
            log(f"[phase] {phase}: {walls[phase]:.1f} s")

    try:
        with torch.inference_mode():
            name, smi_line = timed("1 env", phase_env, torch)
            timed("2 build", phase_build)
            fum_err, main_case, olmoe_case, tp_case = timed(
                "3 FUM kernel", phase_kernels, torch)
            timed("3 scout, block, flash", phase_new_kernels, torch)
            from repro_torch.configs import get_config
            from repro_torch.models import registry
            cfg = get_config("qwen2-1.5b")
            check(cfg.n_layers == N_LAYERS_QWEN, "unexpected qwen2-1.5b depth")
            t0 = time.perf_counter()
            params = registry.init_params(cfg, 0, "cuda")
            torch.cuda.synchronize()
            log(f"[model] qwen2-1.5b bf16 weights "
                f"({cfg.param_count() / 1e9:.2f} B params) initialised in "
                f"{time.perf_counter() - t0:.1f} s")
            prefill_launches, calls = timed(
                "4 aligned prefill", phase_aligned_prefill, torch, cfg,
                params)
            serve_launches, path_err, block_tile_call = timed(
                "5 serving", phase_serving, torch, cfg, params)
            verify = timed("5d prefix, spec", phase_spec_prefix, torch, cfg,
                           params, serve_launches["h1_tokens"])
            stream = timed("5f stream scheduler, approx_softmax",
                           phase_stream, torch, cfg, params)
            faults = timed("5g faults, deadlines, replicas", phase_faults,
                           torch, cfg, params, serve_launches["h1_tokens"])
            tuned = timed("5h profile, cost policy, adaptive spec",
                          phase_autotune, torch, cfg, params,
                          serve_launches["h1_tokens"])
            tp = timed("5k tensor parallel", phase_tp, torch, cfg, params,
                       serve_launches, smi_line)
            del params
            fum_by_fmt, granite = timed("5b granite-8b", phase_granite,
                                        torch)
            timed("5c window", phase_window, torch)
            moe = timed("5e moe, vlm", phase_moe, torch)
            families = timed("5i rwkv6, zamba2, whisper", phase_families,
                             torch)
            with torch.inference_mode(False):
                trained = timed("5j training", phase_train, torch, smi_line)
                sharded = timed("5l sharded training", phase_sharded_train,
                                torch, smi_line)
                dry = timed("5m dry run", phase_dryrun, torch, trained,
                            sharded, smi_line)
                examples = timed("5n examples", phase_examples, torch,
                                 smi_line)
            fum_timed = timed("6 FUM timing", phase_timing, torch, main_case,
                              olmoe_case, tp_case)
            prefill_timed = timed("6 prefill kernels timing",
                                  phase_timing_prefill, torch, calls,
                                  block_tile_call)
            zamba_timed = timed("6 zamba2 prefill kernels timing",
                                phase_timing_zamba2, torch,
                                families.pop("calls"))
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for mode in ("split", "single"):
        k_ms, p_ms, bound, bound_by = fum_timed[mode]
        kernels.append({
            "name": "hdp_paged_fum_decode" + ("" if mode == "split"
                                             else "[single]"),
            "path": mode, "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": serve_launches["fum"][mode],
            "max_abs_err": max(fum_err[mode], path_err[mode]),
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
        })
    kernels[-1]["note"] = ("the one-pass mode (S = 1), the earlier design, "
                           "timed beside the split; fum_splits gives S > 1 "
                           "at every shape the main paths run (olmoe's: its "
                           "own entry)")
    # the FUM runs on the card of phase 5e's graphed serves: olmoe's
    # (B*N = 128, two blocks a row) in its own entry
    olmoe_runs = {k: v for k, v in moe["fum_runs"].items()
                  if k.startswith("olmoe")}
    kernels[0]["launches_by_run"] = {
        "qwen2-1.5b graphed, horizon 1": serve_launches["fum"]["split"],
        "qwen2-1.5b stream scheduler, 24 requests, graphed, horizon 4":
            stream["fum_runs"],
        **faults["fum_runs"],
        **tuned["fum_runs"],
        **{k: v for k, v in moe["fum_runs"].items() if k not in olmoe_runs}}
    for Sq in DRAFT_LENS:
        k_ms, p_ms, bound, bound_by = fum_timed[f"verify{Sq}"]
        launched, err = verify[Sq]
        kernels.append({
            "name": f"hdp_paged_fum_decode[verify Sq={Sq}]", "path": "split",
            "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": launched, "max_abs_err": err,
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
            "note": f"the multi-query verify of a speculative round at "
                    f"draft_len {Sq}, timed at the int8 timing case's widths "
                    f"with {Sq} query rows; launches: 28 per round of width "
                    f"{Sq} over the graphed draft_len-{Sq} serve, its "
                    "capture's warm-up round included",
        })
    for fmt in ("fp8_v", "bf16"):
        k_ms, p_ms, bound, bound_by = fum_timed[fmt]
        kernels.append({
            "name": f"hdp_paged_fum_decode[{fmt}]", "path": "split",
            "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": fum_by_fmt[fmt], "max_abs_err": fum_err[fmt],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
            "note": f"the {fmt} pool format, timed at the int8 timing case's "
                    "values; launches over granite-8b's graphed serve on "
                    "that pool",
        })
    k_ms, p_ms, bound, bound_by = fum_timed["olmoe"]
    kernels.append({
        "name": "hdp_paged_fum_decode[olmoe G=1]", "path": moe["fum_mode"],
        "route": "cuda",
        "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
        "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
        "launches": olmoe_runs["olmoe-1b-7b graphed, horizon 1"],
        "launches_by_run": olmoe_runs,
        "max_abs_err": max(fum_err["olmoe"], moe["fum_err"]),
        "max_abs_err_vs_float64_uniform_codes": fum_err["olmoe_f64"],
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
        "note": f"olmoe-1b-7b's decode shape (MHA, G 1): B*N = 128 rows, "
                f"fum_splits gives S={moe['fum_S']}; timed at B8 N16 G1 hd128 "
                "ps128 with half the 16 page slots live; launches: its "
                "graphed horizon-1 serve (16 layers x (32 decode steps + "
                "1 warm-up))",
        "single_pass_ms": fum_timed["olmoe_single"][0],
    })
    k_ms, p_ms, bound, bound_by = fum_timed["tp2"]
    kernels.append({
        "name": "hdp_paged_fum_decode[tp 2 shard N=1]",
        "path": "split" if tp["fum_by_path"].get("split") else "single",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
        "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
        "launches": tp["runs_per_rank_h1"],
        "launches_by_run": {
            "qwen2-1.5b tp 2, rank 0, eager, horizon 1":
                tp["runs_per_rank_h1"],
            "qwen2-1.5b tp 2, rank 0, eager, horizon 4":
                tp["runs_per_rank_h4"]},
        "max_abs_err": fum_err["tp2"],
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
        "note": "one rank's shard of qwen2-1.5b's decode at tp 2 (phase "
                "5k: two ranks on the card over gloo, eager): one KV head "
                "of two; launches: the kernel's runs on the card on rank 0 "
                "over phase 5's traffic, 28 a decode step; timed at B8 N1 "
                "G6 Sq1 hd128 ps128",
    })
    # entry: (path, source, TPU kernel, launches on the path that runs it)
    entries = {
        "hdp_scout": ("tensor_core", "hdp_scout_tc.cu", "hdp_scout.py:75",
                      prefill_launches["hdp_scout"]),
        "hdp_scout[dp4a]": ("dp4a", "hdp_scout.cu", "hdp_scout.py:75",
                            prefill_launches["hdp_scout[dp4a]"]),
        "hdp_block_sparse_attention": (
            "tensor_core", "hdp_block_attn_tc.cu", "hdp_block_attn.py:91",
            prefill_launches["hdp_block_sparse_attention"]),
        "flash_attention": (
            "tensor_core", "flash_attention_tc.cu", "flash_attention.py:69",
            prefill_launches["flash_attention"]),
        "hdp_block_sparse_attention[tile]": (
            "tile", "hdp_block_attn.cu", "hdp_block_attn.py:91",
            serve_launches["block_tile"]),
        "flash_attention[tile]": (
            "tile", "flash_attention.cu", "flash_attention.py:69",
            prefill_launches["flash_attention[tile]"]),
    }
    for ename, (path, src, tpu, n) in entries.items():
        k_ms, p_ms, bound, bound_by, _, _, lib_ms = prefill_timed[ename]
        kernels.append({
            "name": ename, "path": path, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": n, "max_abs_err": ERRS[ename],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })
        base = ename.split("[")[0]
        if base in NO_LIBRARY_CALL:
            kernels[-1]["library_note"] = NO_LIBRARY_CALL[base]
        if path == "tensor_core":
            kernels[-1]["launches_by_run"] = {
                "qwen2-1.5b aligned prefill": n,
                "olmoe-1b-7b aligned prefill": moe["prefill"][ename]}
    # the examples (phase 5n): the FUM kernel at page size 2 (MHA, G 1)
    # and the scout and block kernels at quickstart's section 3
    for scale, hd in (("tiny", 64), ("base", 32)):
        kernels[0]["launches_by_run"][
            f"bench-{scale} serve_hdp example, ps 2, hd {hd}, graphed"] = \
            examples[f"serve_hdp {scale}"]["fum_runs"]
    for k in kernels:
        if k["name"] == "hdp_block_sparse_attention[tile]":
            k["launches_by_run"] = {
                "qwen2-1.5b pallas_hdp_block decode route, graphed":
                    k["launches"]}
        if k["name"] in ("hdp_scout", "hdp_block_sparse_attention[tile]"):
            k["launches_by_run"]["quickstart example, section 3"] = 1
    import repro_torch.kernels.flash_attention as fa_mod
    import repro_torch.kernels.hdp_block_attn as ba_mod
    import repro_torch.kernels.hdp_scout as sc_mod
    for base, mod, tpu in (
            ("hdp_scout", sc_mod, "hdp_scout.py:75"),
            ("hdp_block_sparse_attention", ba_mod, "hdp_block_attn.py:91"),
            ("flash_attention", fa_mod, "flash_attention.py:69")):
        k_ms, p_ms, bound, bound_by, _, _, lib_ms = zamba_timed[base]
        path = ZAMBA_PATHS[base]
        kernels.append({
            "name": f"{base}[{path}, zamba2-7b hd112]",
            "path": path, "route": "cuda",
            "source": f"src/repro_torch/csrc/{mod.SOURCES[path]}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": families["prefill"][base],
            "max_abs_err": families["errs"][base],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "note": "zamba2-7b's aligned prefill (B 1, 32 heads, S 4096, "
                    "hd 112, bf16): 13 launches, one per shared-block "
                    "invocation; hd 112 takes this path",
        })
        if base == "hdp_scout":
            # the dp4a kernel, which served this shape before, at the
            # same inputs
            kernels[-1]["dp4a_ms"] = zamba_timed["hdp_scout[dp4a]"][0]
        if base in NO_LIBRARY_CALL:
            kernels[-1]["library_note"] = NO_LIBRARY_CALL[base]
    log(f"[examples] phase 5n {json.dumps(examples)}")
    log(f"[train] phase 5j {json.dumps(trained)}")
    log(f"[shard] phase 5l {json.dumps(sharded)}")
    log(f"[dry] phase 5m {json.dumps(dry)}")
    log(f"[families] phase 5i {json.dumps({k: v for k, v in families.items() if k not in ('prefill', 'errs')})}")
    log(f"[granite] routes {json.dumps(granite)}")
    log(f"[moe] olmoe-1b-7b {json.dumps({k: v for k, v in moe.items() if k not in ('calls', 'prefill')})}")
    log(f"[sched] phase 5f {json.dumps({k: v for k, v in stream.items() if k != 'fum_runs'})}")
    log(f"[faults] phase 5g {json.dumps({k: v for k, v in faults.items() if k != 'fum_runs'})}")
    log(f"[tune] phase 5h {json.dumps({k: v for k, v in tuned.items() if k != 'fum_runs'})}")
    log(f"[tp] phase 5k {json.dumps(tp)}")
    log(f"[phase] wall seconds {json.dumps(walls)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank_main(sys.argv[1:]) if "--tp-rank" in sys.argv
             else shard_rank_main(sys.argv[1:]) if "--shard-rank" in sys.argv
             else main())
