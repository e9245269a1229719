"""Batched serving engine with HDP over a block-paged or dense KV cache.

PyTorch counterpart of the greedy core of ``repro.serving.Engine`` for
the decoder-only families: the transformer's (``PAGEABLE_FAMILIES``:
dense, moe, vlm) and the recurrent ones (``RECURRENT_FAMILIES``: rwkv6,
zamba2), which serve from the dense layout, prefill at exact length and
neither chunk nor speculate; an encoder-decoder config raises, as in the
reference. The KV cache is the block-paged pool (``PagedKVCache``:
int8, int8 K + fp8 V, or unquantized pages in the model's dtype, on the
static grid or with absmax page scales; the default for the
transformer) or the dense per-slot layout over any family's cache tree
(``SlotCache``), with HDP on or off:

* **batched bucketed prefill** — queued requests are grouped by pad
  bucket and stacked into one prefill per group (each prompt right-padded
  with its last token); the dense request cache it fills is scattered
  into the slot's freshly allocated pool pages, or copied into its slot;
* **chunked prefill** — a prompt longer than the largest bucket is
  prefilled alone, in chunks of the largest bucket appended at a
  position offset (the last chunk padded to the smallest bucket that
  fits), into a request cache of ``max_len`` positions; this needs the
  largest bucket to be a multiple of HDP's ``block_q`` (with HDP on),
  so that chunk boundaries sit on scout block rows;
* **fused greedy decode** — each ``step()`` runs up to
  ``decode_horizon`` decode steps over all ``max_batch`` slots with one
  host sync. The per-slot state (last token, position, active mask,
  remaining budget, EOS id) lives on the device; every step masks done,
  faulted and parked slots there and writes its outputs into history
  rows the host reads once per horizon. Parked slots get a zeroed table
  row, so their writes land in the scratch page (in the dense layout at
  position 0 of their own, free, slot). On a CUDA device the
  step is one CUDA graph, captured at the first decode and replayed
  (``cuda_graph=False`` steps eagerly instead, as the CPU does). Each
  layer's attention goes through the backend the registry resolves for
  the engine's ``attn`` spec: by default the gather-free FUM kernel
  (``pallas_paged_decode``), or the block-sparse kernel on a densified
  gather (``attn="pallas_hdp_block"``);
* the **prefix cache** (paged layout; ``prefix_cache=`` or
  ``REPRO_PREFIX_CACHE``) — admission first walks a token-chunk radix
  tree (``allocator.RadixPrefixCache``) for the longest cached prompt
  prefix: its full pages are shared into the slot's table (refcounted,
  no copy, no recompute) and only the suffix is prefilled, by the
  chunked prefill at the prefix's offset. A full-prompt hit skips
  prefill and copies (COW) the one shared page the decode's resume
  rewrites. Finished prefills register their full pages before the
  decode write frontier; under pool pressure the least recently used
  unreferenced cached pages are evicted. Each slot's first owned page
  is its write floor, a static device buffer the decode reads beside
  the table: writes below it land in the scratch page;
* **self-speculative decode** (``spec_decode=`` or
  ``REPRO_SPEC_DECODE``; supersedes the horizon) — each ``step()`` is
  one round: ``k - 1`` draft steps propose tokens, scoring attention
  from the int8 scout copies alone (the K pool is neither read nor, on
  an unquantized pool, written), then one ``k``-wide multi-query verify
  re-scores every position at full fidelity, each query row scouted as
  its own single step would be (on the card the FUM kernel at Sq = k).
  The longest agreeing prefix is accepted on the device, so every
  committed token is the exact greedy one (the output equals horizon 1
  at any acceptance rate); EOS and budgets cut commits as the horizon
  does, and the K of rejected staged positions is poisoned (NaN, or the
  int8 code -128), fenced like the writes. ``k`` is ``draft_len``
  clamped to the longest remaining budget; on a CUDA device each width
  is one CUDA graph, captured at its first round. With
  **acceptance-adaptive speculation** (``adaptive_spec=`` or
  ``REPRO_ADAPTIVE_SPEC``; ``autotune.SpecController``) each round's
  ``k`` (1..draft_len, still clamped) and draft profile tier
  (conservative, base or aggressive thresholds) come from an
  acceptance-rate EMA; the thresholds are constants of a captured
  round, so each (k, tier) is its own graph (k = 1 drafts nothing and
  has no tier);
* the **stream scheduler** (``stream_sched=`` or ``REPRO_STREAM_SCHED``;
  ``scheduler.StreamScheduler``) — ``submit()`` enqueues into a waiting
  queue and every ``step()`` runs one scheduling tick before its decode:
  token-budget admission against free slots and free-or-evictable
  pages, priority and biggest-prefix-hit-first ordering, slots vacated
  mid-run refilled at once, long cold prompts prefilled a chunk slice
  per step while the batch decodes, preemption of lower-priority
  requests for a starved queue head (recompute: the generated tokens
  are folded into the prompt), and a watchdog that sheds a request that
  can never be admitted. Admission writes the graph's static buffers
  between replays, on the stream the graph replays on. Per-request
  TTFT, TPOT and queue wait, taken at the host read of each horizon,
  and queue-depth aggregates land in ``summary()``; ``serve()`` yields
  Results in completion order. Scheduling reorders admission only, so
  every request's tokens are the static engine's;
* EOS and budget handling, and the per-slot non-finite tripwire (only
  the faulted request aborts); a finished request frees its pages at
  once (a dense slot is cleared); ``cancel`` aborts a request wherever
  it is, with a typed ``Result(status="cancelled")``; a request past
  its ``deadline_s`` (or, still waiting, its ``max_queue_wait_s``) is
  cancelled at the top of the next step with ``status="deadline"``;
* **fault injection** (``faults=`` or ``REPRO_FAULT_PLAN``;
  ``serving.faults``) — a deterministic plan keyed on the engine's step
  counter: a slow step, an injected ``PoolExhausted`` in ``_reserve``,
  a hard ``InjectedFault`` inside the decode call bracket (before the
  replay; the engine unwinds what the step wrote and stays usable), and
  NaN logits for one request through a ``[max_batch]`` bool buffer that
  the decode step and the verify read (a static buffer of the graphs:
  a fault never re-captures). ``serving.replica.ReplicaSet`` serves N
  engines behind one front-end and fails a dead one's work over;
* the **cost policy** (``AttnSpec(policy="cost")`` or
  ``REPRO_ATTN_POLICY=cost``; ``autotune.Tuner``) — every "auto"
  dispatch is ranked by the tuner's cost model under the device's
  hardware profile. Ambiguous signatures are probed at the top of the
  next step (and when the scheduler recycles a slot), never inside a
  graph capture; a probe that flips a decision bumps the attention
  epoch, which drops every captured graph, so the next step re-captures
  under the new decision (the eager prefill re-consults on every call).

Not ported yet (ROADMAP.md section 1): tensor parallelism (item 8).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.attention import (AttnSpec, DraftProfile, default_spec,
                                   effective_policy, resolve_backend)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import POISON_CODE
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.models import registry
from repro_torch.models.attention import build_attn_call, resolve_write_pages
from repro_torch.models.layers import resolve_device
from repro_torch.serving.allocator import PoolExhausted, RadixPrefixCache
from repro_torch.serving.faults import FaultInjector, FaultPlan, coerce_injector
from repro_torch.serving.kv_cache import (KV_DTYPES, PagedKVCache, SlotCache,
                                          cache_bytes)
from repro_torch.serving.scheduler import (QueueFull, SchedulerConfig,
                                           StreamScheduler)

#: env default of ``decode_horizon`` (the reference's name)
HORIZON_ENV = "REPRO_DECODE_HORIZON"
#: env default of the paged pool's format (the reference's name)
KV_DTYPE_ENV = "REPRO_KV_DTYPE"
#: env default of ``prefix_cache`` (degrades silently where the layout
#: cannot share pages; an explicit True raises there instead)
PREFIX_ENV = "REPRO_PREFIX_CACHE"
#: env default of ``spec_decode``
SPEC_ENV = "REPRO_SPEC_DECODE"
#: env default of ``draft_len`` (else 4)
DRAFT_ENV = "REPRO_DRAFT_LEN"
#: env default of ``stream_sched`` (else off, or on when a ``sched``
#: config is passed)
STREAM_ENV = "REPRO_STREAM_SCHED"
#: env default of ``adaptive_spec`` (degrades silently when spec decode
#: is off; an explicit True raises there instead)
ADAPTIVE_ENV = "REPRO_ADAPTIVE_SPEC"
#: env default of the serve CLI's ``--dp``, the engine replicas behind one
#: ``serving.replica.ReplicaSet`` (the Engine itself is one replica)
MESH_DP_ENV = "REPRO_MESH_DP"
#: families with a seq-indexed KV cache: the paged layout, chunked
#: prefill, the prefix cache and speculative verify serve them
PAGEABLE_FAMILIES = ("dense", "moe", "vlm")
#: families that carry recurrent state: exact-length prefill, and the
#: decode graph's warm-up saves and restores their state whole
RECURRENT_FAMILIES = ("rwkv6", "zamba2")

#: decode backend -> its stage-3 implementation (on the card, on the CPU)
_STAGE3_IMPL = {
    "pallas_paged_decode": ("cuda:hdp_paged_fum_decode",
                            "plain:hdp_paged_fum_decode_ref"),
    "pallas_hdp_block": ("cuda:hdp_block_sparse_attention",
                         "plain:hdp_block_sparse_attention_plain"),
}

#: engine metric -> the decode kernel wrapper whose launches it reads
_DECODE_KERNELS = {"fum_kernel_launches": hdp_paged_fum_decode,
                   "block_kernel_launches": hdp_block_sparse_attention}

#: the per-slot decode stats leaves kept in the history rows (the dense
#: layout has no pages; HDP off has no stats)
_STAT_NAMES = ("block_sparsity", "head_sparsity", "page_sparsity")


def _launch_counts() -> Dict[str, int]:
    return {m: fn.launches for m, fn in _DECODE_KERNELS.items()}


def _key_name(key) -> str:
    """A graph or round key as text: "decode", "k" or "k:tier"."""
    if isinstance(key, str):
        return key
    k, tier = key
    return str(k) if tier is None else f"{k}:{tier}"


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "on")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    #: admission priority (the scheduler's "prefix" order): higher admits
    #: first, and only a strictly lower-priority running request may be
    #: preempted to unblock a starved queue head
    priority: int = 0
    #: wall-clock budget from submit() to completion; past it the request
    #: is cancelled with ``Result(status="deadline")`` wherever it is
    #: (queued, mid-prefill or decoding)
    deadline_s: Optional[float] = None
    #: wall-clock budget from submit() to slot activation; expires only
    #: while the request still waits (an admitted request may finish)
    max_queue_wait_s: Optional[float] = None
    # --- preempt-and-restore bookkeeping (the engine's) ---
    #: tokens generated before the last preemption: folded into
    #: ``prompt`` for the recompute resume, and re-emitted at the head of
    #: the final ``Result.tokens``
    prior_tokens: Tuple[int, ...] = ()
    #: prompt length of the original submission (``prompt`` grows with
    #: each resume); None until the first preemption
    orig_prompt_len: Optional[int] = None
    #: times the request was preempted so far
    preemptions: int = 0


@dataclasses.dataclass
class Result:
    uid: int
    prompt_len: int
    tokens: List[int]
    prefill_s: float = 0.0
    decode_steps: int = 0
    #: False when ``run`` ran out of steps before the request finished
    #: (tokens then hold the partial generation), and for every status
    #: but "ok"
    complete: bool = True
    #: "ok" | "cancelled" | "deadline" | "error" (non-finite logits: the
    #: per-slot tripwire; shed by the scheduler's watchdog; or lost twice
    #: by replica failover)
    status: str = "ok"
    error: Optional[str] = None
    #: times the request was preempted before it finished (its tokens
    #: equal an uninterrupted run's all the same)
    preemptions: int = 0
    #: seconds from submit() to slot activation (queue and prefill wait)
    queue_wait_s: Optional[float] = None
    #: seconds from submit() to the first generated token, at the
    #: granularity of the host read: every token of one horizon or
    #: speculative round shares that read's timestamp
    ttft_s: Optional[float] = None
    #: mean seconds per token after the first (same granularity; None
    #: below two tokens)
    tpot_s: Optional[float] = None


class Engine:
    """Single-card greedy serving engine.

    Parameters
    ----------
    cfg: ModelConfig of a decoder-only family (HDP on or off); an
        encoder-decoder config raises NotImplementedError.
    params: model parameter dict; drawn from ``seed`` when None.
    device: "cuda" (default) or "cpu"; CUDA raises when absent.
    max_batch: decode slot count.
    max_len: longest prompt + generation a slot holds.
    prefill_buckets: pad-to lengths of the batched prefill.
    collect_stats: aggregate HDP block/head/page sparsity.
    attn: AttnSpec, or a backend name or family tag, selecting the
        attention backend per phase and the cache: ``layout`` ("auto":
        paged), ``kv_dtype`` of the paged pool ("auto": REPRO_KV_DTYPE,
        else "int8"; the dense layout always serves the model dtype,
        reported as "fp32") and ``kv_scale``; None uses the default spec
        (which honors REPRO_ATTN_BACKEND).
    num_pages: page-pool size of the paged layout (default: one full
        table per slot plus the scratch page); a larger pool keeps more
        evicted-under-pressure prefix pages resident.
    prefix_cache: share prompt-prefix pages across requests through the
        radix tree (paged layout). None reads REPRO_PREFIX_CACHE and
        degrades silently where pages cannot be shared (the dense
        layout, HDP chunk misalignment); True raises there.
    decode_horizon: decode steps per ``step()`` and host sync; None
        reads REPRO_DECODE_HORIZON (default 1).
    spec_decode: self-speculative decode, one draft/verify round per
        ``step()`` (supersedes the horizon); None reads
        REPRO_SPEC_DECODE (default off). Pins ``hdp.calib = "none"``, as
        the paged layout does: staging leaves garbage past the commit
        frontier, which a data-dependent calibration would see.
    draft_len: tokens proposed and verified per round (1..draft_len
        commit); None reads REPRO_DRAFT_LEN (default 4).
    draft_profile: the draft's DraftProfile (score source, threshold
        overrides); None: scores from the scout copies, the exact
        thresholds.
    adaptive_spec: acceptance-adaptive speculation: an
        ``autotune.SpecController`` keeps an acceptance-rate EMA and
        plans each round's width (1..draft_len) and draft profile tier.
        The tokens stay those of greedy decode at any plan. None reads
        REPRO_ADAPTIVE_SPEC and degrades silently when spec decode is
        off; True without spec decode raises.
    tuner: an ``autotune.Tuner`` to install as the process default,
        which cost-policy dispatch consults (engines share it); None
        keeps the current default. Under the cost policy the default is
        made on first use with the engine's device's profile, and an
        engine whose device the default's profile does not describe
        raises (``autotune.reset_default_tuner()`` or ``tuner=`` fixes
        it): a CPU engine prices with ``HOST_CPU``, a card engine with
        the card's profile.
    cuda_graph: on a CUDA device, run the decode step (and each width of
        speculative round) as one captured CUDA graph (the default);
        False steps eagerly, op by op. A failed capture or replay
        raises. Ignored on the CPU, which always steps eagerly.
    stream_sched: the continuous-batching stream scheduler: ``submit()``
        enqueues into a waiting queue and every ``step()`` runs one
        ``scheduler.StreamScheduler`` tick (token-budget admission,
        priority and prefix-hit-first order, mid-run slot recycling,
        interleaved chunked prefill, preemption, watchdog) before its
        decode. Composes with every decode mode and changes no request's
        tokens, only when and in what order requests are admitted. None
        reads REPRO_STREAM_SCHED (default off); passing a ``sched``
        config implies True.
    sched: SchedulerConfig of the scheduler (chunk token budget per
        step, admission order, watchdog, queue bound, preemption); None
        uses the defaults.
    faults: deterministic fault injection: a ``serving.faults``
        FaultInjector (share one across a ReplicaSet for events that
        fire once fleet-wide), a FaultPlan, or a plan spec string. None
        reads REPRO_FAULT_PLAN (default: no injection). The plan's steps
        count this engine's ``step()`` calls from construction.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 device="cuda", max_batch: int = 4, max_len: int = 128,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 collect_stats: bool = False,
                 attn: Union[AttnSpec, str, None] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 decode_horizon: Optional[int] = None,
                 spec_decode: Optional[bool] = None,
                 draft_len: Optional[int] = None,
                 draft_profile: Optional[DraftProfile] = None,
                 adaptive_spec: Optional[bool] = None,
                 tuner=None,
                 cuda_graph: bool = True,
                 stream_sched: Optional[bool] = None,
                 sched: Optional[SchedulerConfig] = None,
                 faults: Union[FaultInjector, FaultPlan, str, None] = None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only families; an "
                "encoder-decoder model is served at model level "
                "(registry.apply_prefill / apply_decode), as in the "
                "reference")
        if isinstance(attn, str):
            attn = AttnSpec(backend=attn)
        spec = attn if attn is not None else default_spec()
        self.device = resolve_device(device)
        pageable = cfg.family in PAGEABLE_FAMILIES
        layout = spec.layout
        if layout == "auto":
            layout = "paged" if pageable else "dense"
        if layout == "paged" and not pageable:
            raise ValueError(
                f"family {cfg.family!r} has no KV pages; use dense layout")
        kv_dtype = spec.kv_dtype
        if kv_dtype == "auto":
            kv_dtype = os.environ.get(KV_DTYPE_ENV, "") or "int8"
            if kv_dtype not in KV_DTYPES:
                raise ValueError(f"{KV_DTYPE_ENV}={kv_dtype!r}: must be one "
                                 f"of {KV_DTYPES}")
        if layout != "paged":
            kv_dtype = "fp32"     # dense slot caches have no quantized store
        if spec.kv_scale == "absmax" and kv_dtype == "fp32":
            raise ValueError(
                "kv_scale='absmax' calibrates a quantized pool's scales; "
                "it needs kv_dtype='int8'/'fp8_v' and the paged layout")
        # the resolved format goes back into the spec: attn_apply keys its
        # prefill round trip off attn.kv_dtype and attn.kv_scale
        self.attn_spec = spec.replace(kv_dtype=kv_dtype)
        self.paged = layout == "paged"
        self.kv_dtype = kv_dtype
        self.kv_scale = spec.kv_scale if self.paged else "grid"
        hdp = cfg.hdp
        self.hdp_on = hdp is not None and hdp.enabled
        if spec_decode is None:
            spec_decode = _env_flag(SPEC_ENV) and pageable   # env degrades
        elif spec_decode and not pageable:
            raise ValueError(
                f"spec_decode=True: family {cfg.family!r} has no multi-query "
                "verify path (recurrent state cannot re-score draft "
                "positions against a cache)")
        self.spec = bool(spec_decode)
        if draft_len is None:
            draft_len = int(os.environ.get(DRAFT_ENV, "4") or 4)
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        self.draft_len = int(draft_len)
        self.draft_profile = (draft_profile if draft_profile is not None
                              else DraftProfile())
        if adaptive_spec is None:
            adaptive_spec = _env_flag(ADAPTIVE_ENV) and self.spec  # degrades
        elif adaptive_spec and not self.spec:
            raise ValueError(
                "adaptive_spec=True requires spec_decode (there is no "
                "draft length to adapt without speculative rounds)")
        self.spec_ctl = None
        if adaptive_spec:
            from repro_torch.autotune import SpecConfig, SpecController
            self.spec_ctl = SpecController(
                self.draft_profile, hdp if self.hdp_on else None,
                SpecConfig(k_max=self.draft_len))
        #: the draft profile tiers a round may run, by name (base first:
        #: a tier equal to it shares its graphs)
        self._tiers = {"base": self.draft_profile}
        if self.spec_ctl is not None:
            self._tiers.update(aggressive=self.spec_ctl.aggressive,
                               conservative=self.spec_ctl.conservative)
        if (self.paged or self.spec) and self.hdp_on and hdp.calib != "none":
            # the pool's scout view is quantized at write time, and rolled
            # back speculative writes leave garbage past the frontier, so
            # a data-dependent calibration scale cannot be honoured: the
            # static grid applies to prefill and decode alike
            cfg = cfg.replace(hdp=hdp.replace(calib="none"))
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = sorted(b for b in prefill_buckets if b <= max_len) \
            or [max_len]
        self.collect_stats = collect_stats
        if decode_horizon is None:
            decode_horizon = int(os.environ.get(HORIZON_ENV, "1") or 1)
        if decode_horizon < 1:
            raise ValueError(
                f"decode_horizon must be >= 1, got {decode_horizon}")
        self.horizon = int(decode_horizon)
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        self.policy = effective_policy(self.attn_spec)
        self.tuner = None
        if tuner is not None:
            from repro_torch.autotune import set_default_tuner
            set_default_tuner(tuner)
        if self.policy == "cost":
            from repro_torch.autotune import default_tuner
            from repro_torch.roofline.hardware import detect_profile
            self.tuner = default_tuner(self.device)
            want = detect_profile(self.device)
            if self.tuner.hw.name != want.name:
                raise ValueError(
                    f"the process-default tuner prices with "
                    f"{self.tuner.hw.name!r}, but this engine runs on "
                    f"{self.device} ({want.name!r}): pass tuner= or call "
                    "repro_torch.autotune.reset_default_tuner() first")
        #: bumped when a flushed probe flips a tuner decision: the bump
        #: drops every captured graph, so the next step re-captures and
        #: re-consults the tuner
        self._attn_epoch = 0
        for phase in ("prefill", "decode"):
            try:
                self.resolved_backend(phase)
            except KeyError as e:
                raise ValueError(f"{phase}: {e.args[0]}") from None
        if params is None:
            params = registry.init_params(cfg, seed, self.device)
        self.params = params
        if self.paged:
            # the draft scores from the int8 scout copies: the fraction
            # copy costs pool memory only for a speculating unquantized
            # pool (a quantized one derives it from its codes)
            self.pages = PagedKVCache(
                cfg, max_batch, max_len, device=self.device,
                kv_dtype=kv_dtype, kv_scale=self.kv_scale,
                num_pages=num_pages,
                draft_scout=self.spec and self.draft_profile.scores == "scout")
        else:
            # a round stages writes up to draft_len - 1 positions past
            # the commit frontier: the dense slots carry that margin, so
            # a staged write near max_len never clamps onto a committed
            # position (the paged write path sends such columns to the
            # scratch page)
            margin = self.draft_len - 1 if self.spec else 0
            self.slots = SlotCache(cfg, max_batch, max_len + margin,
                                   device=self.device)
        self.prefix = self._build_prefix_cache(prefix_cache)
        self._stat_names = (() if not self.hdp_on else _STAT_NAMES
                            if self.paged else _STAT_NAMES[:2])
        self._free = list(range(max_batch))
        self._active: Dict[int, Dict[str, Any]] = {}   # slot -> state
        self._results: Dict[int, Result] = {}
        self._queue: List[Request] = []
        self.metrics: Dict[str, float] = self._fresh_metrics()
        #: submit() timestamps by uid (popped at finish) and the order in
        #: which requests finished, which ``serve()`` drains
        self._t_submit: Dict[int, float] = {}
        self._finished: List[int] = []
        #: uid -> (absolute deadline, absolute queue-wait deadline),
        #: enforced at the top of every step; popped at finish
        self._deadlines: Dict[int, Tuple[Optional[float],
                                         Optional[float]]] = {}
        #: activation counter: the preemption victim's tiebreak (the
        #: newest activation goes first: it has the least sunk work)
        self._act_seq = 0
        #: the engine's step counter, which the fault plan's steps index
        self._cur_step = 0
        self.faults = coerce_injector(faults)
        if stream_sched is None:
            env = os.environ.get(STREAM_ENV, "")
            stream_sched = (env.lower() in ("1", "true", "on") if env
                            else sched is not None)
        self.sched = StreamScheduler(self, sched or SchedulerConfig()) \
            if stream_sched else None
        self._init_decode_state()

    def _init_decode_state(self) -> None:
        """Static device buffers of the decode step (a captured graph reads
        them at fixed addresses): the reference's ``_last_tok``, ``_pos``,
        ``_active_dev``, ``_remaining_dev``, ``_eos_dev`` and
        ``_floor_dev`` (each slot's write floor, its first owned page),
        written by the host only at activation and finish and advanced in
        place by every step; the fault harness's NaN mask ``_inject``
        (the reference's ``inject`` operand: all False but for the
        horizon or round that poisons a request's logits); and the
        history of one horizon, row ``t``
        per step (token, pre-step active mask and fault mask, [H, 3, B];
        the stats leaves, [H, 3, L, B]), with the device step counter
        ``_t``. A speculative round writes its exact tokens and commit
        mask to ``_hist`` rows ``0..k-1`` (rows 0 and 1 of [., 3, B]),
        its fault mask to row 0's third, and its verify stats to
        ``_hist_stats[0]``."""
        B, dev = self.max_batch, self.device
        H = max(self.horizon, self.draft_len if self.spec else 1)
        i64 = torch.int64
        self._tok = torch.zeros((B, 1), dtype=i64, device=dev)
        self._pos = torch.zeros(B, dtype=i64, device=dev)
        self._act = torch.zeros(B, dtype=torch.bool, device=dev)
        self._rem = torch.zeros(B, dtype=i64, device=dev)
        self._eos = torch.full((B,), -1, dtype=i64, device=dev)
        self._floor = torch.zeros(B, dtype=i64, device=dev)
        self._inject = torch.zeros(B, dtype=torch.bool, device=dev)
        self._t = torch.zeros(1, dtype=i64, device=dev)
        self._hist = torch.zeros((H, 3, B), dtype=i64, device=dev)
        self._hist_stats = torch.zeros(
            (H, len(self._stat_names), registry.attn_layers(self.cfg), B),
            dtype=torch.float32, device=dev) \
            if self.collect_stats and self._stat_names else None
        #: the captured graphs, keyed "decode" (the decode step) or by a
        #: speculative round's (k, tier) (``_round_key``), each with the
        #: launches of each decode kernel recorded into it
        self._graphs: Dict[object, Tuple[torch.cuda.CUDAGraph,
                                         Dict[str, int]]] = {}
        #: per round (k, tier), the decode-kernel launches of the round's
        #: draft steps and of its verify (wrapper counts over the capture,
        #: or over the last eager round)
        self.round_launches: Dict[Tuple[int, Optional[str]],
                                  Dict[str, Dict[str, int]]] = {}

    # --------------------------------------------------------------- public
    @property
    def _can_chunk(self) -> bool:
        """Chunked prefill needs a seq-indexed cache (a pageable family;
        every config the port serves has rope), and with HDP on chunk
        boundaries on HDP q-block boundaries, or the scout's
        per-block-row pooling shifts against a one-shot prefill."""
        if self.cfg.family not in PAGEABLE_FAMILIES:
            return False
        return (not self.hdp_on
                or self.buckets[-1] % self.cfg.hdp.block_q == 0)

    def submit(self, req: Request, *, deadline_s: Optional[float] = None,
               max_queue_wait_s: Optional[float] = None) -> None:
        """Enqueue a request: into the stream scheduler's waiting queue
        when it is on, else into the static queue. ``deadline_s`` and
        ``max_queue_wait_s`` override the request's own fields. Raises
        `QueueFull` when the scheduler's waiting queue is at
        ``SchedulerConfig.max_queue_depth`` (typed backpressure: the
        request is not enqueued and no Result is recorded for it)."""
        if deadline_s is not None:
            req = dataclasses.replace(req, deadline_s=deadline_s)
        if max_queue_wait_s is not None:
            req = dataclasses.replace(req, max_queue_wait_s=max_queue_wait_s)
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+generation exceeds max_len")
        if plen > self.buckets[-1] and not self._can_chunk \
                and not self._exact_prefill:
            raise ValueError(
                f"request {req.uid}: prompt of {plen} tokens exceeds the "
                f"largest prefill bucket ({self.buckets[-1]}), and chunked "
                "prefill needs the largest bucket to be a multiple of HDP's "
                f"block_q ({self.cfg.hdp.block_q})")
        if self.sched is not None:
            depth_max = self.sched.cfg.max_queue_depth
            if depth_max is not None and self.sched.depth >= depth_max:
                self.metrics["queue_rejected"] += 1
                raise QueueFull(
                    f"request {req.uid}: waiting queue at "
                    f"max_queue_depth={depth_max}; back off and resubmit")
        now = time.perf_counter()
        self._t_submit[req.uid] = now
        if req.deadline_s is not None or req.max_queue_wait_s is not None:
            self._deadlines[req.uid] = (
                now + req.deadline_s if req.deadline_s is not None else None,
                now + req.max_queue_wait_s
                if req.max_queue_wait_s is not None else None)
        if self.sched is not None:
            self.sched.enqueue(req)
        else:
            self._queue.append(req)

    def _n_pending(self) -> int:
        """Requests not finished yet: active slots, the static queue, and
        the scheduler's waiting and mid-prefill requests."""
        n = len(self._queue) + len(self._active)
        if self.sched is not None:
            n += self.sched.depth
        return n

    def _pending_requests(self) -> List[Request]:
        reqs = list(self._queue)
        if self.sched is not None:
            reqs += self.sched.pending_requests()
        return reqs

    def _sample_queue_depth(self) -> None:
        """One queue-depth sample per step, after the tick: the depth the
        step decodes under."""
        d = self.sched.depth
        m = self.metrics
        m["queue_depth_sum"] += d
        m["queue_depth_samples"] += 1
        m["queue_depth_peak"] = max(m["queue_depth_peak"], d)

    def run(self, max_steps: int = 10_000, *,
            strict: bool = False) -> Dict[int, Result]:
        """Step until every submitted request completes. If ``max_steps``
        steps run out first, the unfinished Results are marked
        ``complete=False`` (active slots keep their partial tokens,
        waiting requests get an empty Result) and a RuntimeWarning is
        issued, or with ``strict`` a RuntimeError raised; the engine's
        state stays intact, so a further ``run()`` continues."""
        steps = 0
        while self._n_pending() and steps < max_steps:
            self.step()
            steps += 1
        if self._n_pending():
            waiting = self._pending_requests()
            msg = (f"Engine.run: step budget {max_steps} exhausted with "
                   f"{len(self._active)} active and {len(waiting)} "
                   f"queued request(s) unfinished")
            for st in self._active.values():
                res = self._results[st["req"].uid]
                res.tokens = list(st["generated"])
                res.decode_steps = len(res.tokens)
                res.complete = False
            for req in waiting:
                self._results[req.uid] = Result(req.uid, len(req.prompt), [],
                                                complete=False)
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return dict(self._results)

    def serve(self, reqs: Optional[Sequence[Request]] = None, *,
              max_steps: int = 10_000):
        """Streaming serve loop: yields each Result as it completes.

        ``reqs`` are submitted first (beside anything already submitted);
        more may be submitted between yields, and the loop steps until
        nothing is pending. Results come in completion order. Raises
        RuntimeError when ``max_steps`` steps pass without draining."""
        if reqs is not None:
            for r in reqs:
                self.submit(r)
        emitted = len(self._finished)   # results from before the loop
        steps = 0
        while self._n_pending():
            if steps >= max_steps:
                raise RuntimeError(
                    f"Engine.serve: step budget {max_steps} exhausted "
                    f"with {self._n_pending()} request(s) unfinished")
            self.step()
            steps += 1
            while emitted < len(self._finished):
                uid = self._finished[emitted]
                emitted += 1
                yield self._results[uid]

    def results(self) -> Dict[int, Result]:
        """Every Result recorded so far (finished requests, and the
        active ones' partial shells)."""
        return dict(self._results)

    def step(self) -> int:
        """Run the fault plan's slow events and cancel expired requests,
        admit what fits (with the stream scheduler: one tick, whose
        progress feeds its watchdog), then one decode horizon over all
        slots: up to ``decode_horizon`` steps (never past the longest
        remaining budget), or with ``spec_decode`` one speculative
        round, with one host sync. Returns the number of active slots
        stepped. Under the cost policy the tuner's pending probes run
        first, after the deadlines (``_maybe_retune``)."""
        try:
            return self._step_inner(self._cur_step)
        finally:
            # one increment per call, raise or return: the fault hooks
            # key on this counter, and _reserve reads it mid-step
            self._cur_step += 1

    def _step_inner(self, step_no: int) -> int:
        if self.faults is not None:
            self.faults.sleep(step_no)
        self._enforce_deadlines()
        self._maybe_retune()
        if self.sched is not None:
            t0 = time.perf_counter()
            ticked = self.sched.tick()
            # wall time of the tick: its policy, and the admissions'
            # prefills (counted in prefill_s as well)
            self.metrics["sched_tick_s"] += time.perf_counter() - t0
            self._sample_queue_depth()
        else:
            self._admit()
        if not self._active:
            if self.sched is not None:
                self.sched.watchdog(ticked)
            return 0
        n_stepped = len(self._active)
        rem_max = max(st["req"].max_new_tokens - len(st["generated"])
                      for st in self._active.values())
        if self.spec:
            self._spec_step(rem_max, step_no)
        else:
            self._decode_horizon(min(self.horizon, rem_max), step_no)
        if self.sched is not None:
            self.sched.watchdog(True)      # decode progressed
        return n_stepped

    def _maybe_retune(self) -> None:
        """Flush pending tuner probes (host side, between device steps).

        A measured winner that flips a standing cost decision bumps the
        attention epoch and drops every captured graph (each holds the
        kernels of the old decision), so the next decode re-captures and
        re-consults the tuner; the eager prefill re-consults on every
        call. Called at the top of every step and by the stream scheduler
        when a recycled slot re-enters the batch, never inside a graph
        capture. No-op under the static policy."""
        if self.tuner is not None and self.tuner.flush_probes():
            self._attn_epoch += 1
            self._graphs.clear()

    # ------------------------------------------------------------ admission
    @property
    def _exact_prefill(self) -> bool:
        """Recurrent state: prefilling pad tokens would corrupt it, so
        these families prefill at exact length (one call per length)."""
        return self.cfg.family in RECURRENT_FAMILIES

    def _bucket_for(self, n: int) -> int:
        if self._exact_prefill:
            return n
        return next(b for b in self.buckets if n <= b)   # n fits a bucket

    def _admit(self) -> None:
        n = min(len(self._queue), len(self._free))
        if n == 0:
            return
        take = [self._queue.pop(0) for _ in range(n)]
        groups: Dict[int, List[Request]] = {}
        long_reqs: List[Request] = []
        hits: List = []
        for req in take:
            if self._can_chunk and len(req.prompt) > self.buckets[-1]:
                # long prompts prefill one at a time: their match waits,
                # so they can hit pages this wave's earlier ones register
                long_reqs.append(req)
                continue
            shared = self._prefix_match(req) if self.prefix else None
            if shared:
                hits.append((req, shared))
            else:
                groups.setdefault(self._bucket_for(len(req.prompt)),
                                  []).append(req)
        jobs = [(b, groups[b][i:i + self.max_batch])
                for b in sorted(groups)
                for i in range(0, len(groups[b]), self.max_batch)]
        # every item is popped before it runs: a failing item unwinds
        # itself, the except arm unwinds only the never-started rest (no
        # request dropped, no match ref released twice)
        try:
            while jobs:
                bucket, reqs = jobs.pop(0)
                self._prefill_group(bucket, reqs)
            while hits:
                req, shared = hits.pop(0)
                self._serve_hit(req, shared)
            while long_reqs:
                req = long_reqs.pop(0)
                shared = self._prefix_match(req) if self.prefix else None
                if shared:
                    self._serve_hit(req, shared)
                else:
                    self._serve_cold(req)
        except BaseException:
            for _, reqs in jobs:                 # never-started groups
                self._queue[:0] = reqs
            for req, shared in hits:
                self.pages.allocator.unref(shared)
                self._queue.append(req)
            self._queue.extend(long_reqs)
            raise

    @property
    def _store(self):
        """The serving cache: the page pool or the dense slot cache (each
        takes ``insert(one_cache, slot, row)`` and holds ``.cache``)."""
        return self.pages if self.paged else self.slots

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------- prefix cache
    def _build_prefix_cache(self, requested) -> Optional[RadixPrefixCache]:
        capable = self.paged and self._can_chunk
        if requested is None:
            requested = _env_flag(PREFIX_ENV) and capable   # env degrades
        if not requested:
            return None
        if not self.paged:
            raise ValueError("prefix_cache=True requires the paged cache "
                             "layout (AttnSpec(layout='paged'))")
        if not self._can_chunk:
            raise ValueError(
                "prefix_cache=True needs the suffix prefilled at an offset: "
                "the largest prefill bucket must be a multiple of HDP's "
                f"block_q ({self.cfg.hdp.block_q})")
        return RadixPrefixCache(self.pages.allocator, self.pages.page_size)

    @property
    def _page_align(self) -> int:
        """Pages per shareable unit: a match ends on an HDP q-block
        boundary, or the suffix's scout would pool across it."""
        if self.hdp_on:
            ps = self.pages.page_size
            return math.lcm(ps, self.cfg.hdp.block_q) // ps
        return 1

    def _prefix_match(self, req: Request) -> Optional[List[int]]:
        """Longest usable cached prefix of the prompt, as ref'd pages."""
        return self.prefix.match(req.prompt, align=self._page_align) or None

    def _reserve(self, need: int) -> List[int]:
        """Allocate fresh pages, evicting LRU cached prefixes on pressure."""
        if self.faults is not None \
                and self.faults.pool_exhausted(self._cur_step):
            self.metrics["faults_injected"] += 1
            raise PoolExhausted(
                f"injected pool exhaustion (engine step {self._cur_step})")
        short = need - self.pages.allocator.available
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short)
        return self.pages.allocator.alloc(need)

    def _pages_for(self, req: Request) -> int:
        return max(1, -(-(len(req.prompt) + req.max_new_tokens)
                        // self.pages.page_size))

    def _pages_capacity(self) -> int:
        """Pages an admission could obtain now: the free list plus what
        LRU eviction could reclaim from the prefix cache."""
        cap = self.pages.allocator.available
        if self.prefix is not None:
            cap += self.prefix.evictable_pages()
        return cap

    def _register_prefix(self, req: Request, slot: int) -> None:
        """Cache the slot's full prompt pages strictly before the decode
        write frontier (the resume rewrite at ``plen - 1``): from here on
        a registered page is never written."""
        n_reg = (len(req.prompt) - 1) // self.pages.page_size
        if n_reg > 0:
            self.prefix.insert(req.prompt[:n_reg * self.pages.page_size],
                               self.pages.slot_pages(slot)[:n_reg])

    def _serve_hit(self, req: Request, shared: List[int]) -> None:
        """Serve a prefix-cache hit, unwinding cleanly on failure.

        The fresh pages are reserved first. If the pool cannot supply
        them, the hit releases its match refs (which may pin every
        evictable page) and serves cold, which may then evict them. A
        later failure before the slot owns the pages releases the refs
        and the reserved pages and requeues the request; once the slot
        owns them (``assigned``), the slot's teardown covers them."""
        full = len(shared) * self.pages.page_size == len(req.prompt)
        need = self._pages_for(req) - len(shared) + (1 if full else 0)
        try:
            fresh = self._reserve(need)
        except PoolExhausted:
            self.pages.allocator.unref(shared)
            self._serve_cold(req)
            return
        except BaseException:
            self.pages.allocator.unref(shared)
            self._queue.append(req)
            raise
        slot = self._free.pop(0)
        assigned: List[int] = []
        try:
            if full:
                self._install_hit(req, shared, fresh, slot, assigned)
            else:
                self._prefill_suffix(req, shared, fresh, slot, assigned)
        except BaseException:
            if slot in self._active:
                raise        # activated: the live request owns its teardown
            if assigned:
                self.pages.free(slot)
            else:
                self.pages.allocator.unref(shared + fresh)
            self._free.insert(0, slot)
            self._queue.append(req)
            raise

    def _serve_cold(self, req: Request) -> None:
        """Prefill a request from scratch (no page sharing)."""
        if self._can_chunk and len(req.prompt) > self.buckets[-1]:
            try:
                self._prefill_long(req)
            except BaseException:
                self._queue.append(req)
                raise
        else:
            self._prefill_group(self._bucket_for(len(req.prompt)), [req])

    @torch.no_grad()
    def _prefill_suffix(self, req: Request, shared: List[int],
                        fresh: List[int], slot: int,
                        assigned: List[int]) -> None:
        """Prefix hit: a request cache seeded with the shared pages' K/V
        (a gather, no recompute), the suffix prefilled into it in chunks
        at offset ``m``, and only the suffix and generation pages fresh
        (the insert sends the shared span to the scratch page)."""
        m = len(shared) * self.pages.page_size
        prompt = np.asarray(req.prompt, np.int64)
        t0 = time.perf_counter()
        cache = self.pages.gather_prefix(shared)
        self._chunk_loop(prompt, cache, m)
        self._sync()
        dt = time.perf_counter() - t0
        self.metrics["prefill_s"] += dt
        self.metrics["prefill_calls"] += 1
        self.pages.assign(slot, shared + fresh, first_owned=len(shared))
        assigned.append(slot)            # the slot owns every page now
        self.pages.insert(cache, slot, 0, first_page=len(shared))
        self._activate(req, slot, dt, floor=len(shared))
        self._register_prefix(req, slot)

    def _install_hit(self, req: Request, shared: List[int],
                     fresh: List[int], slot: int,
                     assigned: List[int]) -> None:
        """Full-prompt hit: no prefill. The decode's resume rewrites the
        last prompt position, in the last shared page, so that page is
        copied into an owned one first (COW) and the shared original
        stays immutable for its other readers."""
        self.pages.cow(shared[-1], fresh[0])
        self.metrics["cow_copies"] += 1
        pages = shared[:-1] + [fresh[0]] + fresh[1:]
        self.pages.assign(slot, pages, first_owned=len(shared) - 1)
        assigned.append(slot)            # the slot owns every page now
        self.pages.allocator.unref([shared[-1]])   # COW'd out of the slot
        self._activate(req, slot, 0.0, floor=len(shared) - 1)

    @torch.no_grad()
    def _prefill_group(self, bucket: int, reqs: List[Request]) -> None:
        """One prefill over same-bucket requests, stacked at exact batch
        size, then the scatter of each row into its slot's pages."""
        nb = len(reqs)
        toks = np.zeros((nb, bucket), np.int64)
        for r, req in enumerate(reqs):
            plen = len(req.prompt)
            toks[r, :plen] = np.asarray(req.prompt, np.int64)
            # positions past plen are causally invisible to the real rows
            # and overwritten by decode before they are ever attended
            toks[r, plen:] = toks[r, plen - 1]
        slots = [self._free.pop(0) for _ in reqs]
        try:
            if self.paged:
                for req, slot in zip(reqs, slots):
                    self.pages.assign(slot,
                                      self._reserve(self._pages_for(req)))
            t0 = time.perf_counter()
            cache = registry.init_cache(self.cfg, nb, bucket,
                                        device=self.device)
            _, cache, stats = registry.apply_prefill(
                self.cfg, self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)}, cache,
                collect_stats=self.collect_stats, attn=self.attn_spec)
            for r, slot in enumerate(slots):
                self._store.insert(cache, slot, row=r)
            self._sync()
            dt = time.perf_counter() - t0
        except BaseException:
            # roll admission back: nothing leaks, nothing drops
            if self.paged:
                for slot in slots:
                    self.pages.free(slot)
            self._free[:0] = slots
            self._queue[:0] = reqs
            raise
        self._record_stats(stats)
        self.metrics["prefill_s"] += dt
        self.metrics["prefill_calls"] += 1
        self.metrics["prefill_tokens"] += nb * bucket
        for req, slot in zip(reqs, slots):
            self._activate(req, slot, dt / nb)
            if self.prefix is not None:
                self._register_prefix(req, slot)

    def _tail_len(self, rem: int, off: int) -> int:
        """Length of the last chunk: the smallest bucket that holds the
        ``rem`` remaining tokens and fits below max_len, else ``rem``."""
        for b in self.buckets:
            if b >= rem and off + b <= self.max_len:
                return b
        return rem

    def _chunk_step(self, prompt: np.ndarray, cache, off: int) -> int:
        """Prefill one chunk of ``prompt`` at position ``off`` into the
        request cache (in place); returns the next offset."""
        plen = len(prompt)
        chunk = self.buckets[-1]
        rem = plen - off
        clen = chunk if rem >= chunk else self._tail_len(rem, off)
        piece = np.full((1, clen), prompt[plen - 1], np.int64)
        piece[0, :min(rem, clen)] = prompt[off:off + clen]
        _, _, stats = registry.apply_prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(piece).to(self.device)}, cache,
            collect_stats=self.collect_stats, pos_offset=off,
            attn=self.attn_spec)
        self._record_stats(stats)
        self.metrics["prefill_tokens"] += clen
        return off + clen

    def _chunk_loop(self, prompt: np.ndarray, cache, off: int) -> None:
        while off < len(prompt):
            off = self._chunk_step(prompt, cache, off)

    @torch.no_grad()
    def _prefill_long(self, req: Request) -> None:
        """Chunked prefill of one prompt longer than the largest bucket
        into a ``max_len`` request cache, then its install. Equal to
        one-shot prefill only where no head's integer scout sums to 0
        over a single chunk: HDP's early head gate applies per forward
        call, even at tau_h = 0, as in the JAX reference."""
        prompt = np.asarray(req.prompt, np.int64)
        t0 = time.perf_counter()
        cache = registry.init_cache(self.cfg, 1, self.max_len,
                                    device=self.device)
        self._chunk_loop(prompt, cache, 0)
        self._sync()
        dt = time.perf_counter() - t0
        self.metrics["prefill_s"] += dt
        self.metrics["prefill_calls"] += 1
        self._install(req, cache, 0, dt)

    # ------------------------------------------------- interleaved prefill
    def _begin_stream_prefill(self, req: Request) -> Dict[str, Any]:
        """Open an incremental chunked prefill for the stream scheduler.

        The slot and the request's whole page footprint are reserved up
        front, so a begun prefill can always complete: later pool
        pressure defers other admissions and never strands a half
        prefilled prompt. ``_advance_stream_prefill`` advances the
        returned state one token-budget slice per engine step, with
        decode running in between. The request cache is allocated here,
        outside any graph capture, from the default memory pool."""
        pages = self._reserve(self._pages_for(req)) if self.paged else []
        slot = self._free.pop(0)
        return {"req": req, "slot": slot, "pages": pages,
                "prompt": np.asarray(req.prompt, np.int64),
                "cache": registry.init_cache(self.cfg, 1, self.max_len,
                                             device=self.device),
                "off": 0, "spent": 0.0}

    @torch.no_grad()
    def _advance_stream_prefill(self, st: Dict[str, Any],
                                budget: int) -> bool:
        """Advance an interleaved prefill by at least one chunk, up to
        ``budget`` prompt tokens; install and activate it when it is
        done (returns True). The chunk step and the install are the ones
        ``_prefill_long`` runs in one blocking loop, so the tokens are
        identical; only the pacing differs."""
        prompt = st["prompt"]
        plen = len(prompt)
        t0 = time.perf_counter()
        done = 0
        while st["off"] < plen and done < budget:
            off0 = st["off"]
            st["off"] = self._chunk_step(prompt, st["cache"], off0)
            done += st["off"] - off0
            self.metrics["sched_chunk_tokens"] += st["off"] - off0
        self._sync()
        st["spent"] += time.perf_counter() - t0
        if st["off"] < plen:
            return False
        self.metrics["prefill_s"] += st["spent"]
        self.metrics["prefill_calls"] += 1
        req, slot = st["req"], st["slot"]
        try:
            if self.paged:
                self.pages.assign(slot, st["pages"])
                st["pages"] = []           # owned by the slot from here
            self._store.insert(st["cache"], slot, row=0)
            self._activate(req, slot, st["spent"])
        except BaseException:
            # roll the slot back; _abort_stream_prefill (the scheduler's
            # unwind) returns it and any pages still held, and requeues
            if self.paged and self.pages.slot_pages(slot):
                self.pages.free(slot)
            self._active.pop(slot, None)
            raise
        st["installed"] = True
        if self.prefix is not None:
            self._register_prefix(req, slot)
        return True

    def _abort_stream_prefill(self, st: Dict[str, Any]) -> None:
        """Unwind a failed interleaved prefill: pages and slot return to
        their pools (a prefill that reached activation keeps its slot:
        the live request owns the teardown from there)."""
        if st.get("installed"):
            return
        if self.paged and st["pages"]:
            self.pages.allocator.unref(st["pages"])
        self._free.insert(0, st["slot"])

    def _install(self, req: Request, one_cache, row: int,
                 prefill_s: float) -> None:
        """Give a prefilled request a slot and pages, and arm it."""
        if self.paged:
            pages = self._reserve(self._pages_for(req))   # fallible: first
        slot = self._free.pop(0)
        try:
            if self.paged:
                self.pages.assign(slot, pages)
            self._store.insert(one_cache, slot, row=row)
            self._activate(req, slot, prefill_s)
        except BaseException:
            # roll the slot back (requeueing is the caller's job): pages
            # return through the slot if assigned, directly otherwise
            if self.paged:
                if self.pages.slot_pages(slot):
                    self.pages.free(slot)
                else:
                    self.pages.allocator.unref(pages)
            self._active.pop(slot, None)
            self._free.insert(0, slot)
            raise
        if self.prefix is not None:
            self._register_prefix(req, slot)

    def _activate(self, req: Request, slot: int, prefill_s: float,
                  floor: int = 0) -> None:
        """Arm a slot: the first decode step replays the last prompt token
        at its own position (an idempotent K/V rewrite, in an owned page:
        ``floor`` fences the shared prefix) and yields the first
        generated token."""
        self._active[slot] = {"req": req, "generated": [],
                              "act_seq": self._act_seq}
        self._act_seq += 1
        # prompt_len is the original submission's (a resume folds the
        # generated tokens into req.prompt)
        res = Result(req.uid, req.orig_prompt_len or len(req.prompt), [],
                     prefill_s=prefill_s, preemptions=req.preemptions)
        t_sub = self._t_submit.get(req.uid)
        if t_sub is not None:
            res.queue_wait_s = time.perf_counter() - t_sub
        self._results[req.uid] = res
        self._tok[slot] = int(req.prompt[-1])
        self._pos[slot] = len(req.prompt) - 1
        self._act[slot] = True
        self._rem[slot] = req.max_new_tokens
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._floor[slot] = floor

    # --------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode_body(self) -> None:
        """One decode step on the device state alone (the reference's
        ``_decode_step`` plus one ``body`` of ``_decode_loop``): parked
        slots read and write the scratch page, the rows ``_inject`` marks
        get NaN logits (the fault harness), the argmax feeds the next
        step, a slot whose logits go non-finite is faulted, done (budget
        or EOS) and faulted slots park, and the step's outputs go to
        history row ``_t``. Nothing is read back to the host, so a CUDA
        graph can hold it."""
        act = self._act
        logits, _, stats = registry.apply_decode(
            self.cfg, self.params, self._tok, self._store.cache,
            self._pos[:, None], collect_stats=self.collect_stats,
            attn=self.attn_spec, **self._table_kw())
        last = self._poison(logits)[:, -1]
        nxt = torch.argmax(last, dim=-1)
        # per-slot tripwire: a non-finite logit row means this request's
        # state is poisoned; only that request aborts
        fault = act & ~torch.isfinite(last).all(dim=-1)
        done = act & ~fault & ((self._rem <= 1)
                               | ((self._eos >= 0) & (nxt == self._eos)))
        gone = done | fault
        self._hist.index_copy_(
            0, self._t, torch.stack([nxt, act.long(), fault.long()])[None])
        if self._hist_stats is not None:
            self._hist_stats.index_copy_(0, self._t, torch.stack(
                [stats[n] for n in self._stat_names])[None])
        self._t.add_(1)
        self._rem.sub_(act.long())
        self._tok.copy_(torch.where(gone, 0, nxt)[:, None])
        self._pos.copy_(torch.where(gone, 0, self._pos + 1))
        self._act.copy_(act & ~gone)

    def _poison(self, logits: torch.Tensor) -> torch.Tensor:
        """The fault harness's NaN injection: the rows of ``logits``
        ([B, S, V]) whose slot ``_inject`` marks become NaN, so the
        tripwire fires as it would for organic NaNs."""
        return torch.where(self._inject[:, None, None], float("nan"), logits)

    def _table_kw(self) -> Dict[str, Any]:
        """The decode's paged-layout arguments (none in the dense
        layout, whose families' steps take no table)."""
        if not self.paged:
            return {}
        table, floor = self._step_table()
        return {"page_table": table, "write_floor": floor}

    def _step_table(self):
        """The decode's page table (parked slots' rows zeroed, so their
        writes land in the scratch page) and write floors; (None, None)
        in the dense layout."""
        if not self.paged:
            return None, None
        return (torch.where(self._act[:, None], self.pages.table(), 0),
                self._floor)

    def _step_once(self) -> None:
        """One decode step (see ``_run``)."""
        self._run("decode", self._decode_body, 1)

    def _run(self, key, body: Callable[[], None], width: int) -> None:
        """Run ``body``: a replay of graph ``key`` (captured at its first
        run) or, with ``cuda_graph`` off and on the CPU, the body run
        eagerly. The engine's launch counts take the wrappers' count of
        an eager run, and what the capture recorded per replay."""
        if not self.cuda_graph:
            before = _launch_counts()
            body()
            for m, n in _launch_counts().items():
                self.metrics[m] += n - before[m]
            return
        if key not in self._graphs:
            self._graphs[key] = self._capture(body, width)
        graph, launches = self._graphs[key]
        graph.replay()
        for m, n in launches.items():
            self.metrics[m] += n

    def _capture(self, body: Callable[[], None], width: int):
        """Capture ``body`` (the decode step, or a speculative round that
        writes ``width`` positions a slot) into a CUDA graph. Every slot
        is parked for the warm-up (an eager run on a side stream, which
        builds and loads the kernels, creates the cuBLAS handles and
        loads lazy modules before capture), so its pool writes land in
        the scratch page; in the dense layout ``_parked`` saves and
        restores what the warm-up rewrites, at the first capture and at
        a re-capture mid-serve alike. Returns the graph and the wrappers'
        counts taken over the capture: what each replay launches. The
        garbage collector is off during the capture: a dead engine left
        in a reference cycle (a caller's closure over one of its methods,
        say) still holds its graphs, and freeing one of them then would
        invalidate the capture."""
        t0 = time.perf_counter()
        with self._parked(width):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            alloc0 = torch.cuda.memory_allocated(self.device)
            res0 = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    body()
            finally:
                if collecting:
                    gc.enable()
            launches = {m: n - before[m]
                        for m, n in _launch_counts().items()}
            self.metrics["graph_allocated_bytes"] += \
                torch.cuda.memory_allocated(self.device) - alloc0
            self.metrics["graph_reserved_bytes"] += \
                torch.cuda.memory_reserved(self.device) - res0
        torch.cuda.synchronize(self.device)
        self.metrics["graph_captures"] += 1
        self.metrics["graph_capture_s"] += time.perf_counter() - t0
        return graph, launches

    @contextlib.contextmanager
    def _parked(self, width: int):
        """Every slot parked for a capture's warm-up step, and the state
        that step rewrites restored after it: the decode state, and in
        the dense layout positions ``0..width-1`` of each slot's
        position-indexed leaves and the whole of each recurrent state
        leaf (``SlotCache.leaves``)."""
        state = (self._tok, self._pos, self._act, self._rem, self._t)
        if not self.paged:
            state += tuple(t if seq is None else t.narrow(seq, 0, width)
                           for t, _, seq in self.slots.leaves())
        saved = [x.clone() for x in state]
        for x in state[:4]:
            x.zero_()
        try:
            yield
        finally:
            for x, s in zip(state, saved):
                x.copy_(s)

    def _read(self, bufs: List[torch.Tensor]) -> List[np.ndarray]:
        """The one host sync of a horizon or round: ``bufs`` as numpy."""
        if self.device.type == "cuda":
            host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                    for b in bufs]
            for h, b in zip(host, bufs):
                h.copy_(b, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            bufs = host
        return [b.numpy() for b in bufs]

    def _read_history(self, length: int):
        """A horizon's history rows as numpy (int64 [length, 3, B]; fp32
        stats [length, 3, L, B] or None), in one host sync."""
        bufs = [self._hist[:length]]
        if self._hist_stats is not None:
            bufs.append(self._hist_stats[:length])
        out = self._read(bufs)
        return out[0], (out[1] if len(out) > 1 else None)

    def _inject_mask(self, step_no: int) -> bool:
        """Write the NaN mask of this horizon or round (the reference's
        ``_inject_mask``): the slots of the live requests whose ``nan``
        events are due. Host-side, between replays, on the stream the
        graph replays on; returns whether any slot was marked (the
        caller zeroes the mask after the host read)."""
        if self.faults is None:
            return False
        by_uid = {st["req"].uid: slot for slot, st in self._active.items()}
        uids = self.faults.nan_uids(step_no, by_uid)
        for u in uids:
            self._inject[by_uid[u]] = True
        self.metrics["faults_injected"] += len(uids)
        return bool(uids)

    def _fault_bracket(self, step_no: int, run: Callable[[], Any]):
        """The decode call bracket: the NaN mask written, the injected
        step error (before ``run`` replays anything, so a raise leaves
        every static buffer as the step found it), then ``run`` (the
        replays and the host read). The mask is zeroed after, raise or
        return."""
        injected = self._inject_mask(step_no)
        try:
            if self.faults is not None:
                self.faults.step_error(step_no)
            return run()
        finally:
            if injected:
                self._inject.zero_()

    def _decode_horizon(self, length: int, step_no: int) -> None:
        """``length`` decode steps with no sync between them, one read of
        the history, then the host walk: emit tokens, finish slots at EOS
        or budget, abort faulted slots only."""
        t0 = time.perf_counter()

        def run():
            self._t.zero_()
            for _ in range(length):
                self._step_once()
            return self._read_history(length)

        hist, stats = self._fault_bracket(step_no, run)
        t_sync = time.perf_counter()
        self.metrics["decode_s"] += t_sync - t0
        toks, act, fault = hist[:, 0], hist[:, 1] > 0, hist[:, 2] > 0
        any_act = act.any(axis=1)
        ran = int(any_act.sum())               # steps with any active slot
        self.metrics["decode_steps"] += ran
        if stats is not None:
            for t in range(ran):
                self._record_stats(dict(zip(self._stat_names, stats[t])),
                                   mask=act[t])
        for t in range(ran):
            for slot in list(self._active):
                if not act[t, slot]:
                    continue
                if fault[t, slot]:
                    self._finish(slot, t_sync, status="error",
                                 error="non-finite logits (per-slot tripwire)")
                    continue
                self._emit(slot, int(toks[t, slot]), t_sync)

    # ---------------------------------------------------- speculative round
    def _round_key(self, k: int, profile: DraftProfile):
        """The graph and ``round_launches`` key of a round: (k, the name
        of the profile's tier), or (1, None) at k = 1, which runs no
        draft step. A tier's thresholds are constants of its captured
        draft calls, so no tier may replay another's graph."""
        if k == 1:
            return (1, None)
        for name, tier in self._tiers.items():
            if tier == profile:
                return (k, name)
        raise ValueError(f"draft profile {profile} is none of the engine's "
                         f"tiers {self._tiers}")

    @torch.no_grad()
    def _spec_body(self, k: int,
                   profile: Optional[DraftProfile] = None) -> None:
        """One self-speculative round of width ``k`` on the device state
        alone (the reference's ``_spec_round``); nothing is read back to
        the host, so a CUDA graph can hold it.

        Draft: ``k - 1`` decode steps under the draft profile ``profile``
        (None: the engine's ``draft_profile``) propose
        d_1..d_{k-1} (their staged K/V writes go through the normal,
        floor-fenced write path). Verify: one ``k``-wide multi-query
        decode over [last committed, d_1..d_{k-1}] re-scores every
        position at full fidelity, rewrites their K/V exactly, and gives
        the exact greedy token e_j per row (the rows ``_inject`` marks
        get NaN logits; the draft steps never read it). Accept: e_1..e_m
        commit, where m - 1 is the longest prefix with d_j == e_j; EOS and the
        budget cut commits as the horizon does; a slot whose verify
        logits are not finite is faulted and commits nothing. The K of
        rejected staged positions is poisoned. Writes the exact tokens
        and commit mask to ``_hist`` rows 0..k-1, the fault mask to
        ``_hist[0, 2]`` and the verify stats to ``_hist_stats[0]``, and
        records the draft's and the verify's kernel launches. The two
        parts run under the profiler ranges "spec_draft" and
        "spec_verify" (``launch/profile_decode.py`` splits a round's
        device time by them)."""
        profile = self.draft_profile if profile is None else profile
        act, tok, pos = self._act, self._tok, self._pos
        table, floor = self._step_table()
        c0 = _launch_counts()
        drafts = []
        tok_i, pos_i = tok, pos
        with torch.profiler.record_function("spec_draft"):
            for _ in range(k - 1):
                logits, _, _ = registry.apply_decode(
                    self.cfg, self.params, tok_i, self._store.cache,
                    pos_i[:, None], page_table=table, write_floor=floor,
                    draft=profile, attn=self.attn_spec)
                tok_i = torch.argmax(logits[:, -1], dim=-1)[:, None]
                pos_i = pos_i + 1
                drafts.append(tok_i)
        c1 = _launch_counts()
        ver_in = torch.cat([tok] + drafts, dim=1)               # [B, k]
        steps = torch.arange(k, device=self.device)
        with torch.profiler.record_function("spec_verify"):
            logits, _, stats = registry.apply_decode(
                self.cfg, self.params, ver_in, self._store.cache,
                pos[:, None] + steps[None], collect_stats=self.collect_stats,
                page_table=table, write_floor=floor, attn=self.attn_spec)
        c2 = _launch_counts()
        self.round_launches[self._round_key(k, profile)] = {
            "draft": {m: c1[m] - c0[m] for m in c0},
            "verify": {m: c2[m] - c1[m] for m in c0}}
        logits = self._poison(logits)
        exact = torch.argmax(logits, dim=-1)                     # [B, k]
        fault = act & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
        # longest accepted prefix: drafts[:, j] proposed what the verify
        # re-derived as exact[:, j]; the first mismatch still commits
        # the exact token
        agree = ver_in[:, 1:] == exact[:, :k - 1]
        n_best = 1 + torch.cumprod(agree.long(), dim=1).sum(dim=1)
        within = steps[None] < n_best[:, None]
        eos = self._eos[:, None]
        is_eos = (eos >= 0) & (exact == eos)
        cut = (is_eos & within).long()
        eos_before = torch.cumsum(cut, dim=1) - cut     # EOS strictly before
        commit = (within & (eos_before == 0)
                  & (steps[None] < self._rem[:, None]) & act[:, None]
                  & ~fault[:, None])
        n_commit = commit.sum(dim=1)
        self._poison_rejected(table, floor, n_commit, k)
        eos_hit = (is_eos & commit).any(dim=1)
        rem = self._rem - n_commit
        done = act & ~fault & (eos_hit | (rem <= 0))
        live = act & ~done & ~fault
        last = torch.gather(exact, 1, torch.clamp(n_commit - 1, min=0)[:, None])
        self._hist[:k, 0].copy_(exact.T)
        self._hist[:k, 1].copy_(commit.T.long())
        self._hist[0, 2].copy_(fault.long())
        if self._hist_stats is not None:
            self._hist_stats[0].copy_(torch.stack(
                [stats[n] for n in self._stat_names]))
        self._rem.copy_(rem)
        self._tok.copy_(torch.where(live[:, None], last, 0))
        self._pos.copy_(torch.where(live, pos + n_commit, 0))
        self._act.copy_(live)

    def _poison_rejected(self, table, floor, n_commit, k: int) -> None:
        """Rollback fence: poison the K of the rejected staged positions
        ``pos + n_commit .. pos + k - 1`` of active slots, which the next
        round rewrites before any read; a stale read would turn the
        logits NaN (the tripwire) instead of giving a wrong token. K only
        (masked V reads still multiply exact zeros). Unquantized pools
        take NaN, quantized ones the int8 code -128 (stage 3 decodes it
        to NaN, the scout views to 0). The fences are the writes' own
        (``resolve_write_pages``): pages below the floor are never
        touched. The shape is gather, then write back: lanes that are
        not rejected rewrite what they read instead of going to the
        scratch page, which must stay finite (a gated head's softmax
        still reads it)."""
        act, pos = self._act, self._pos
        steps = torch.arange(k, device=self.device)
        stale = pos[:, None] + steps[None]                       # [B, k]
        reject = act[:, None] & (steps[None] >= n_commit[:, None])
        if self.paged:
            kp = self.pages.cache["k_pages"]                 # [L,P,ps,N,hd]
            ps = self.pages.page_size
            ent = resolve_write_pages(stale, table, ps, floor).long()
            reject = reject & (ent != 0)     # never poison the scratch page
            off = stale % ps
            poison = POISON_CODE if kp.dtype == torch.int8 else float("nan")
            cur = kp[:, ent, off]                            # [L,B,k,N,hd]
            kp[:, ent, off] = torch.where(
                reject[None, :, :, None, None],
                torch.full_like(cur, poison), cur)
            return
        kc = self.slots.cache["k"]                           # [L,B,S,N,hd]
        b = torch.arange(self.max_batch, device=self.device)[:, None]
        cur = kc[:, b, stale]
        kc[:, b, stale] = torch.where(reject[None, :, :, None, None],
                                      torch.full_like(cur, float("nan")), cur)

    def _spec_step(self, rem_max: int, step_no: int) -> None:
        """One speculative round, one read of its history, then the host
        walk (the reference's ``_spec_step``): emit each slot's commits
        in order, finish slots at EOS or budget, abort faulted slots
        after the drain. The round's width k is ``draft_len``, or the
        adaptive controller's plan (with its draft profile tier), never
        past ``rem_max``, the longest remaining budget: no slot could
        commit those proposals. The controller then folds the round's
        acceptance in."""
        if self.spec_ctl is not None:
            k_plan, profile = self.spec_ctl.plan()
            k = min(k_plan, rem_max)
        else:
            k, profile = min(self.draft_len, rem_max), self.draft_profile
        key = self._round_key(k, profile)
        t0 = time.perf_counter()
        bufs = [self._hist[:k]]
        if self._hist_stats is not None:
            bufs.append(self._hist_stats[0])

        def run():
            self._run(key, lambda: self._spec_body(k, profile), k)
            return self._read(bufs)

        out = self._fault_bracket(step_no, run)
        t_sync = time.perf_counter()
        self.metrics["decode_s"] += t_sync - t0
        toks, com = out[0][:, 0], out[0][:, 1] > 0             # [k, B]
        fault = out[0][0, 2] > 0                                 # [B]
        n_act = len(self._active)
        self.metrics["spec_rounds"] += 1
        self.metrics["draft_tokens"] += (k - 1) * n_act
        # each active slot that did not fault commits >= 1 exact token;
        # the commits beyond it are accepted draft proposals
        accepted = int(com.sum()) - (n_act - int(fault.sum()))
        self.metrics["accepted_tokens"] += accepted
        self.metrics["decode_steps"] += int(com.any(axis=1).sum())
        if self.spec_ctl is not None:
            self.spec_ctl.update(accepted, (k - 1) * n_act)
        if len(out) > 1 and com.any():
            # one verify sample per round, over the slots that decoded
            self._record_stats(dict(zip(self._stat_names, out[1])),
                               mask=com.any(axis=0))
        for t in range(k):
            if not com[t].any():
                break
            for slot in list(self._active):
                if com[t, slot]:
                    self._emit(slot, int(toks[t, slot]), t_sync)
        # a faulted slot committed nothing (the tripwire fires at the
        # verify, before any accept): abort it after the drain
        for slot in list(self._active):
            if fault[slot]:
                self._finish(slot, t_sync, status="error",
                             error="non-finite logits (per-slot tripwire)")

    def _emit(self, slot: int, tok: int, t_sync: float) -> None:
        """One generated token of an active slot, read at ``t_sync`` (the
        first token's read is its request's TTFT); finishes the slot at
        its budget or EOS."""
        st = self._active[slot]
        req = st["req"]
        if not st["generated"]:
            st["t_first"] = t_sync
        st["generated"].append(tok)
        self.metrics["tokens_out"] += 1
        if len(st["generated"]) >= req.max_new_tokens or \
                (req.eos_id is not None and tok == req.eos_id):
            self._finish(slot, t_sync)

    def _finish(self, slot: int, now: Optional[float] = None, *,
                status: str = "ok", error: Optional[str] = None) -> None:
        """Finish an active request: its Result (tokens generated before
        a preemption first, then TTFT and TPOT from ``now``, the host
        read that ended it), then the slot parked."""
        st = self._active.pop(slot)
        req = st["req"]
        res = self._results[req.uid]
        res.tokens = list(req.prior_tokens) + st["generated"]
        res.decode_steps = len(res.tokens)
        res.complete = status == "ok"
        res.status, res.error = status, error
        res.preemptions = req.preemptions
        if status != "ok":
            self._count_status(status)
        t_sub = self._t_submit.pop(req.uid, None)
        self._deadlines.pop(req.uid, None)
        t_first = st.get("t_first")
        if t_sub is not None and t_first is not None:
            res.ttft_s = t_first - t_sub
        if now is not None and t_first is not None and len(res.tokens) > 1:
            res.tpot_s = (now - t_first) / (len(res.tokens) - 1)
        self._finished.append(req.uid)
        self._park_slot(slot)

    def _park_slot(self, slot: int) -> None:
        """Release a slot's cache state, park its static device state,
        and return it to the free pool. Its table row is zeroed (later
        decode writes of the parked slot land in the scratch page; a
        dense slot is cleared); unref, not free: pages the prefix cache
        or another slot still holds survive the slot. The decode step
        parks a slot that finished on the device itself, but a
        preempted or cancelled slot is still armed there, so the host
        zeroes its token, position, active flag, budget and floor (on
        the stream the graph replays on, between replays)."""
        if self.paged:
            self.pages.free(slot)
        else:
            self.slots.clear(slot)
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._act[slot] = False
        self._rem[slot] = 0
        self._floor[slot] = 0
        self._free.append(slot)

    def _count_status(self, status: str) -> None:
        key = {"cancelled": "req_cancelled",
               "deadline": "req_deadline"}.get(status, "req_errors")
        self.metrics[key] += 1

    # ---------------------------------------------------- request lifecycle
    def _fail_request(self, req: Request, *, status: str,
                      error: Optional[str] = None) -> None:
        """Finish a request that never reached a slot, or no longer holds
        one, with a typed Result that is not "ok"; tokens generated
        before a preemption are kept."""
        res = Result(req.uid, req.orig_prompt_len or len(req.prompt),
                     list(req.prior_tokens), complete=False, status=status,
                     error=error, preemptions=req.preemptions)
        res.decode_steps = len(res.tokens)
        t_sub = self._t_submit.pop(req.uid, None)
        if t_sub is not None:
            res.queue_wait_s = time.perf_counter() - t_sub
        self._deadlines.pop(req.uid, None)
        self._results[req.uid] = res
        self._finished.append(req.uid)
        self._count_status(status)

    def cancel(self, uid: int, *, status: str = "cancelled",
               error: Optional[str] = None) -> bool:
        """Abort a request wherever it is (decoding in a slot, in an
        interleaved prefill, or queued), unwinding its pages, slot and
        radix refs, with a typed ``Result(status=...)``. Returns True
        when the request was found (False: unknown or finished)."""
        for slot, st in list(self._active.items()):
            if st["req"].uid == uid:
                self._finish(slot, time.perf_counter(), status=status,
                             error=error)
                return True
        for req in list(self._queue):
            if req.uid == uid:
                self._queue.remove(req)
                self._fail_request(req, status=status, error=error)
                return True
        if self.sched is not None:
            req = self.sched.cancel(uid)
            if req is not None:
                self._fail_request(req, status=status, error=error)
                return True
        return False

    def _enforce_deadlines(self) -> None:
        """Cancel expired requests, once at the top of every step (a
        deadline's granularity is the engine step, as the host reads the
        device once per horizon)."""
        if not self._deadlines:
            return
        now = time.perf_counter()
        active_uids = {st["req"].uid for st in self._active.values()}
        for uid, (dl, qdl) in list(self._deadlines.items()):
            if dl is not None and now >= dl:
                self.cancel(uid, status="deadline",
                            error=f"deadline_s exceeded after {now - dl:.3f}s")
            elif qdl is not None and now >= qdl and uid not in active_uids:
                self.cancel(uid, status="deadline",
                            error="max_queue_wait_s exceeded before "
                                  "activation")

    # ----------------------------------------------------- preempt, restore
    @staticmethod
    def _make_resume(req: Request, generated: List[int]) -> Request:
        """The recompute resume of a running request: its generated
        tokens extend the prompt and its budget shrinks to match. Greedy
        decode and the chunked-prefill equivalence make serving it give
        the tokens of a run that was never interrupted."""
        return dataclasses.replace(
            req,
            prompt=list(req.prompt) + list(generated),
            max_new_tokens=req.max_new_tokens - len(generated),
            prior_tokens=tuple(req.prior_tokens) + tuple(generated),
            orig_prompt_len=req.orig_prompt_len or len(req.prompt),
            preemptions=req.preemptions + 1)

    def _preempt_victim(self, max_priority: int) -> Optional[int]:
        """Slot of the best preemption victim: the lowest priority
        strictly below ``max_priority``, the newest activation among
        ties. None when nothing ranks below: equal priorities never
        preempt each other, so the default (all 0) cannot livelock."""
        cands = [(st["req"].priority, -st["act_seq"], slot)
                 for slot, st in self._active.items()
                 if st["req"].priority < max_priority]
        return min(cands)[2] if cands else None

    def _preempt(self, slot: int) -> Request:
        """Tear a running slot down (pages freed, slot parked and
        recycled) and return its recompute resume. Its Result shell stays
        registered; the resume's activation replaces it."""
        st = self._active.pop(slot)
        resume = self._make_resume(st["req"], st["generated"])
        self._park_slot(slot)
        self.metrics["sched_preempted"] += 1
        return resume

    # -------------------------------------------------------------- metrics
    @staticmethod
    def _fresh_metrics() -> Dict[str, float]:
        return {"prefill_s": 0.0, "prefill_calls": 0, "prefill_tokens": 0,
                "decode_s": 0.0, "decode_steps": 0, "tokens_out": 0,
                "block_sparsity": 0.0, "head_sparsity": 0.0,
                "page_sparsity": 0.0, "stat_samples": 0, "page_samples": 0,
                "fum_kernel_launches": 0, "block_kernel_launches": 0,
                "graph_captures": 0, "graph_capture_s": 0.0,
                "graph_allocated_bytes": 0, "graph_reserved_bytes": 0,
                "cow_copies": 0, "spec_rounds": 0, "draft_tokens": 0,
                "accepted_tokens": 0,
                # stream-scheduler counters (zero when it is off)
                "sched_admitted": 0, "sched_recycled": 0,
                "sched_deferred": 0, "sched_chunk_tokens": 0,
                "sched_interleaved_steps": 0, "sched_tick_s": 0.0,
                "queue_depth_sum": 0,
                "queue_depth_samples": 0, "queue_depth_peak": 0,
                "sched_preempted": 0, "watchdog_shed": 0,
                "queue_rejected": 0, "faults_injected": 0,
                "req_cancelled": 0, "req_deadline": 0, "req_errors": 0}

    def reset_metrics(self) -> None:
        """Zero the serving metrics (after a warm-up pass, say, so the
        reported rates leave out one-time costs)."""
        self.metrics = self._fresh_metrics()

    @staticmethod
    def _masked_mean(x, mask) -> float:
        """Mean over real samples: decode leaves are [L, B] and the active
        mask drops parked slots; prefill leaves ([L]) pass through."""
        x = np.asarray(x)
        if mask is not None and x.ndim >= 2 and x.shape[-1] == len(mask):
            x = x[..., mask]
        return float(np.mean(x))

    def _record_stats(self, stats, mask=None) -> None:
        """Accumulate one stats sample (leaves with a layer dim: tensors
        from prefill, numpy rows of the decode history)."""
        if stats is None:
            return
        m = self.metrics
        means = {}
        for name in _STAT_NAMES:
            if name in stats:
                x = stats[name]
                if isinstance(x, torch.Tensor):
                    x = x.cpu().numpy()
                means[name] = self._masked_mean(x, mask)
                m[name] += means[name]
        m["page_samples"] += "page_sparsity" in stats
        m["stat_samples"] += 1
        if self.tuner is not None and "page_sparsity" in means:
            # sharpen the cost model's sparse terms with measured decode
            # sparsity (prefill samples carry no page field and would
            # skew the decode-centric EMA)
            self.tuner.observe_sparsity(means["block_sparsity"],
                                        means["head_sparsity"],
                                        means["page_sparsity"])

    def resolved_backend(self, phase: str) -> str:
        """Name of the backend the registry resolves for a serving phase
        ("prefill" | "decode" | "draft" | "verify", the last two the
        speculative round's), from the same call constructor as
        ``attn_apply``, so the report cannot drift from the dispatch.
        Under the cost policy the tuner's standing decision for the
        phase (what the dispatch ran) takes precedence; before any
        dispatch the static resolution is reported."""
        if phase not in ("prefill", "decode", "draft", "verify"):
            raise ValueError(f"phase must be prefill, decode, draft or "
                             f"verify, got {phase!r}")
        if self.cfg.family == "rwkv6":
            return "none"            # no attention layer to dispatch
        decode = phase != "prefill"
        call = build_attn_call(
            self.cfg, mode="decode" if decode else "prefill",
            paged=self.paged and decode, per_slot=decode,
            collect_stats=self.collect_stats,
            draft=self.draft_profile if phase == "draft" else None,
            verify=phase == "verify", kv_scale=self.kv_scale)
        if self.tuner is not None:
            dec = self.tuner.decision_for(call)
            if dec is not None:
                return dec
        return resolve_backend(call, self.attn_spec).name

    def _stage3(self, backend: str) -> str:
        """The stage-3 implementation a decode-like backend runs: its
        kernel on the card, its plain version for CPU tensors; the FUM
        kernel's scout view assumes the static grid, so absmax pools run
        the plain PyTorch stage (paged_hdp_decode's)."""
        if backend == "pallas_paged_decode" and self.kv_scale == "absmax":
            backend = "paged_hdp_decode"
        return _STAGE3_IMPL.get(backend, (backend,) * 2)[
            self.device.type != "cuda"]

    def summary(self) -> Dict[str, Any]:
        m = dict(self.metrics)
        if m["decode_s"] > 0:
            # decode_s holds the one-time capture, as the reference's
            # holds its first compile; the steady rate leaves it out
            m["decode_tok_s"] = m["tokens_out"] / m["decode_s"]
            m["decode_tok_s_steady"] = m["tokens_out"] / (
                m["decode_s"] - m["graph_capture_s"])
        if m["stat_samples"]:
            m["block_sparsity"] /= m["stat_samples"]
            m["head_sparsity"] /= m["stat_samples"]
        if m["page_samples"]:
            m["page_sparsity"] /= m["page_samples"]
        m["completed"] = sum(r.complete for r in self._results.values())
        m["stream_sched"] = self.sched is not None
        n_depth = m.pop("queue_depth_samples")
        depth_sum = m.pop("queue_depth_sum")
        if n_depth and self.sched is not None:
            m["queue_depth_mean"] = depth_sum / n_depth
            m["sched_ticks"] = n_depth
        ttfts = sorted(r.ttft_s for r in self._results.values()
                       if r.ttft_s is not None)
        if ttfts:
            m["ttft_s_mean"] = float(np.mean(ttfts))
            m["ttft_s_p50"] = float(ttfts[int(0.5 * (len(ttfts) - 1))])
            m["ttft_s_p95"] = float(ttfts[int(0.95 * (len(ttfts) - 1))])
        tpots = [r.tpot_s for r in self._results.values()
                 if r.tpot_s is not None]
        if tpots:
            m["tpot_s_mean"] = float(np.mean(tpots))
        waits = [r.queue_wait_s for r in self._results.values()
                 if r.queue_wait_s is not None]
        if waits:
            m["queue_wait_s_mean"] = float(np.mean(waits))
        m["device"] = str(self.device)
        m["decode_horizon"] = self.horizon
        m["cuda_graph"] = self.cuda_graph
        m["attn_backend_prefill"] = self.resolved_backend("prefill")
        m["attn_backend_decode"] = decode = self.resolved_backend("decode")
        m["attn_decode_stage3"] = self._stage3(decode)
        m["attn_policy"] = self.policy
        if m["decode_steps"]:
            m["meas_decode_step_s"] = m["decode_s"] / m["decode_steps"]
        if self.tuner is not None:
            ts = self.tuner.stats()
            m["tuner_hits"] = ts["hits"]
            m["tuner_misses"] = ts["misses"]
            m["tuner_probes"] = ts["probes"]
            m["tuner_cached"] = ts["measured"]
            # under spec decode the per-round hot path is the multi-query
            # verify call, not a plain decode step: predict what ran (a
            # family without attention has no call to price)
            est = None if self.cfg.family == "rwkv6" else \
                self.tuner.estimate_for(build_attn_call(
                    self.cfg, mode="decode", paged=self.paged,
                    per_slot=True, collect_stats=self.collect_stats,
                    verify=self.spec, kv_scale=self.kv_scale))
            if est is not None:
                from repro_torch.autotune import predict_engine_step
                m["pred_decode_step_s"] = predict_engine_step(
                    registry.param_count(self.cfg, active_only=True),
                    self.max_batch, self.cfg.n_layers, est[1],
                    self.tuner.hw)
        if self.faults is not None:
            m["fault_plan"] = self.faults.plan.spec
            m["faults_fired"] = len(self.faults.fired)
        m["spec_decode"] = self.spec
        if self.spec:
            m["draft_len"] = self.draft_len
            m["acceptance_rate"] = (m["accepted_tokens"] / m["draft_tokens"]
                                    if m["draft_tokens"] else 0.0)
            m["attn_backend_draft"] = draft = self.resolved_backend("draft")
            m["attn_backend_verify"] = verify = \
                self.resolved_backend("verify")
            m["attn_draft_stage3"] = self._stage3(draft)
            m["attn_verify_stage3"] = self._stage3(verify)
            m["spec_graphs"] = sum(k != "decode" for k in self._graphs)
            m["round_launches"] = {_key_name(k): v for k, v in
                                   self.round_launches.items()}
            m["adaptive_spec"] = self.spec_ctl is not None
            if self.spec_ctl is not None:
                sc = self.spec_ctl.summary()
                m["acceptance_ema"] = sc["acceptance_ema"]
                m["draft_len_mean"] = sc["draft_len_mean"]
                m["spec_plans"] = sc["rounds"]
        m["layout"] = "paged" if self.paged else "dense"
        m["kv_dtype"] = self.kv_dtype
        m["kv_scale"] = self.kv_scale
        if self.paged:
            # resident bytes at the allocation high-water mark
            m["cache_bytes"] = self.pages.active_bytes(self.pages.peak_pages)
            m["cache_bytes_pool"] = self.pages.pool_bytes()
            m["cache_bytes_per_token"] = self.pages.bytes_per_token()
            m["pages_peak"] = self.pages.peak_pages
            m["pages_in_use"] = self.pages.pages_in_use
            m["page_size"] = self.pages.page_size
            m["prefix_cache"] = self.prefix is not None
            if self.prefix is not None:
                m["prefix_hits"] = self.prefix.hits
                m["prefix_misses"] = self.prefix.misses
                m["prefix_hit_tokens"] = self.prefix.hit_tokens
                m["prefix_evictions"] = self.prefix.evictions
                m["pages_cached"] = self.prefix.cached_pages
        else:
            m["cache_bytes"] = cache_bytes(self.slots.cache)
            m["cache_bytes_per_token"] = self.slots.bytes_per_token()
        return m
