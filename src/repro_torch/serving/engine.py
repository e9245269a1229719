"""Batched serving engine with HDP over a block-paged or dense KV cache.

PyTorch counterpart of the greedy core of ``repro.serving.Engine`` for
dense transformer families. The KV cache is the block-paged pool
(``PagedKVCache``: int8, int8 K + fp8 V, or unquantized pages in the
model's dtype, on the static grid or with absmax page scales; the
default for the dense family) or the dense per-slot layout
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
* EOS and budget handling, and the per-slot non-finite tripwire (only
  the faulted request aborts); a finished request frees its pages at
  once (a dense slot is cleared).

Not ported yet (ROADMAP.md section 1): the prefix cache, speculative
decode, the stream scheduler, fault handling and tensor parallelism.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.attention import AttnSpec, default_spec, resolve_backend
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.models import registry
from repro_torch.models.attention import build_attn_call
from repro_torch.models.layers import resolve_device
from repro_torch.serving.kv_cache import (KV_DTYPES, PagedKVCache, SlotCache,
                                          cache_bytes)

#: env default of ``decode_horizon`` (the reference's name)
HORIZON_ENV = "REPRO_DECODE_HORIZON"
#: env default of the paged pool's format (the reference's name)
KV_DTYPE_ENV = "REPRO_KV_DTYPE"

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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Result:
    uid: int
    prompt_len: int
    tokens: List[int]
    prefill_s: float = 0.0
    decode_steps: int = 0
    #: False when ``run`` ran out of steps before the request finished
    #: (tokens then hold the partial generation)
    complete: bool = True
    #: "ok" | "error" (non-finite logits: the per-slot tripwire)
    status: str = "ok"
    error: Optional[str] = None


class Engine:
    """Single-card greedy serving engine.

    Parameters
    ----------
    cfg: ModelConfig (dense family, HDP on or off).
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
    decode_horizon: decode steps per ``step()`` and host sync; None
        reads REPRO_DECODE_HORIZON (default 1).
    cuda_graph: on a CUDA device, run the decode step as one captured
        CUDA graph (the default); False steps it eagerly, op by op. A
        failed capture or replay raises. Ignored on the CPU, which
        always steps eagerly.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 device="cuda", max_batch: int = 4, max_len: int = 128,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 collect_stats: bool = False,
                 attn: Union[AttnSpec, str, None] = None,
                 decode_horizon: Optional[int] = None,
                 cuda_graph: bool = True):
        if isinstance(attn, str):
            attn = AttnSpec(backend=attn)
        spec = attn if attn is not None else default_spec()
        self.device = resolve_device(device)
        layout = "paged" if spec.layout == "auto" else spec.layout
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
        if self.paged and self.hdp_on and hdp.calib != "none":
            # the pool's scout view is quantized at write time, so a
            # data-dependent calibration scale cannot be honoured: the
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
        for phase in ("prefill", "decode"):
            try:
                self.resolved_backend(phase)
            except KeyError as e:
                raise ValueError(f"{phase}: {e.args[0]}") from None
        if params is None:
            params = registry.init_params(cfg, seed, self.device)
        self.params = params
        if self.paged:
            self.pages = PagedKVCache(cfg, max_batch, max_len,
                                      device=self.device, kv_dtype=kv_dtype,
                                      kv_scale=self.kv_scale)
        else:
            self.slots = SlotCache(cfg, max_batch, max_len,
                                   device=self.device)
        self._stat_names = (() if not self.hdp_on else _STAT_NAMES
                            if self.paged else _STAT_NAMES[:2])
        self._free = list(range(max_batch))
        self._active: Dict[int, Dict[str, Any]] = {}   # slot -> state
        self._results: Dict[int, Result] = {}
        self._queue: List[Request] = []
        self.metrics: Dict[str, float] = self._fresh_metrics()
        self._init_decode_state()

    def _init_decode_state(self) -> None:
        """Static device buffers of the decode step (a captured graph reads
        them at fixed addresses): the reference's ``_last_tok``, ``_pos``,
        ``_active_dev``, ``_remaining_dev`` and ``_eos_dev``, written by the
        host only at activation and finish and advanced in place by every
        step; and the history of one horizon, row ``t`` per step (token,
        pre-step active mask and fault mask, [H, 3, B]; the stats leaves,
        [H, 3, L, B]), with the device step counter ``_t``."""
        B, H, dev = self.max_batch, self.horizon, self.device
        i64 = torch.int64
        self._tok = torch.zeros((B, 1), dtype=i64, device=dev)
        self._pos = torch.zeros(B, dtype=i64, device=dev)
        self._act = torch.zeros(B, dtype=torch.bool, device=dev)
        self._rem = torch.zeros(B, dtype=i64, device=dev)
        self._eos = torch.full((B,), -1, dtype=i64, device=dev)
        self._t = torch.zeros(1, dtype=i64, device=dev)
        self._hist = torch.zeros((H, 3, B), dtype=i64, device=dev)
        self._hist_stats = torch.zeros(
            (H, len(self._stat_names), self.cfg.n_layers, B),
            dtype=torch.float32, device=dev) \
            if self.collect_stats and self._stat_names else None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        #: launches of each decode kernel recorded into the graph
        self._graph_launches: Dict[str, int] = {}

    # --------------------------------------------------------------- public
    @property
    def _can_chunk(self) -> bool:
        """With HDP on, chunk boundaries must sit on HDP q-block
        boundaries, or the scout's per-block-row pooling shifts against a
        one-shot prefill (the port serves only rope dense models, which
        chunk)."""
        return (not self.hdp_on
                or self.buckets[-1] % self.cfg.hdp.block_q == 0)

    def submit(self, req: Request) -> None:
        """Enqueue a request."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+generation exceeds max_len")
        if plen > self.buckets[-1] and not self._can_chunk:
            raise ValueError(
                f"request {req.uid}: prompt of {plen} tokens exceeds the "
                f"largest prefill bucket ({self.buckets[-1]}), and chunked "
                "prefill needs the largest bucket to be a multiple of HDP's "
                f"block_q ({self.cfg.hdp.block_q})")
        self._queue.append(req)

    def run(self, max_steps: int = 10_000) -> Dict[int, Result]:
        """Step until every submitted request completes (or ``max_steps``
        steps ran; unfinished Results are then marked incomplete)."""
        steps = 0
        while (self._queue or self._active) and steps < max_steps:
            self.step()
            steps += 1
        for st in self._active.values():
            res = self._results[st["req"].uid]
            res.tokens = list(st["generated"])
            res.decode_steps = len(res.tokens)
            res.complete = False
        for req in self._queue:
            self._results[req.uid] = Result(req.uid, len(req.prompt), [],
                                            complete=False)
        return dict(self._results)

    def step(self) -> int:
        """Admit what fits, then one decode horizon over all slots: up to
        ``decode_horizon`` steps (never past the longest remaining
        budget) with one host sync. Returns the number of active slots
        stepped."""
        self._admit()
        if not self._active:
            return 0
        n_stepped = len(self._active)
        rem_max = max(st["req"].max_new_tokens - len(st["generated"])
                      for st in self._active.values())
        self._decode_horizon(min(self.horizon, rem_max))
        return n_stepped

    # ------------------------------------------------------------ admission
    def _bucket_for(self, n: int) -> int:
        return next(b for b in self.buckets if n <= b)   # n fits a bucket

    def _admit(self) -> None:
        n = min(len(self._queue), len(self._free))
        if n == 0:
            return
        take = [self._queue.pop(0) for _ in range(n)]
        groups: Dict[int, List[Request]] = {}
        long_reqs: List[Request] = []
        for req in take:
            if len(req.prompt) > self.buckets[-1]:   # submit checked chunking
                long_reqs.append(req)
            else:
                groups.setdefault(self._bucket_for(len(req.prompt)),
                                  []).append(req)
        jobs = [(b, groups[b][i:i + self.max_batch])
                for b in sorted(groups)
                for i in range(0, len(groups[b]), self.max_batch)]
        # every item is popped before it runs: a failing item unwinds
        # itself, the except arm requeues only the never-started rest
        try:
            while jobs:
                bucket, reqs = jobs.pop(0)
                self._prefill_group(bucket, reqs)
            while long_reqs:
                req = long_reqs.pop(0)
                try:
                    self._prefill_long(req)
                except BaseException:
                    self._queue.append(req)
                    raise
        except BaseException:
            for _, reqs in jobs:                 # never-started groups
                self._queue[:0] = reqs
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
                    self.pages.alloc(slot,
                                     len(req.prompt) + req.max_new_tokens)
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

    def _install(self, req: Request, one_cache, row: int,
                 prefill_s: float) -> None:
        """Give a prefilled request a slot and pages, and arm it."""
        slot = self._free.pop(0)
        try:
            if self.paged:
                self.pages.alloc(slot, len(req.prompt) + req.max_new_tokens)
            self._store.insert(one_cache, slot, row=row)
            self._activate(req, slot, prefill_s)
        except BaseException:
            # roll the slot back (requeueing is the caller's job)
            if self.paged:
                self.pages.free(slot)
            self._active.pop(slot, None)
            self._free.insert(0, slot)
            raise

    def _activate(self, req: Request, slot: int, prefill_s: float) -> None:
        """Arm a slot: the first decode step replays the last prompt token
        at its own position (an idempotent K/V rewrite) and yields the
        first generated token."""
        self._active[slot] = {"req": req, "generated": []}
        self._results[req.uid] = Result(req.uid, len(req.prompt), [],
                                        prefill_s=prefill_s)
        self._tok[slot] = int(req.prompt[-1])
        self._pos[slot] = len(req.prompt) - 1
        self._act[slot] = True
        self._rem[slot] = req.max_new_tokens
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id

    # --------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode_body(self) -> None:
        """One decode step on the device state alone (the reference's
        ``_decode_step`` plus one ``body`` of ``_decode_loop``): parked
        slots read and write the scratch page, the argmax feeds the next
        step, a slot whose logits go non-finite is faulted, done (budget
        or EOS) and faulted slots park, and the step's outputs go to
        history row ``_t``. Nothing is read back to the host, so a CUDA
        graph can hold it."""
        act = self._act
        table = (torch.where(act[:, None], self.pages.table(), 0)
                 if self.paged else None)
        logits, _, stats = registry.apply_decode(
            self.cfg, self.params, self._tok, self._store.cache,
            self._pos[:, None], collect_stats=self.collect_stats,
            page_table=table, attn=self.attn_spec)
        last = logits[:, -1]
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

    def _step_once(self) -> None:
        """One decode step: a replay of the captured graph (captured at
        the first call) or, with ``cuda_graph`` off and on the CPU, the
        body run eagerly. The engine's launch counts take the wrappers'
        count of an eager step, and what the capture recorded per
        replay."""
        if not self.cuda_graph:
            before = _launch_counts()
            self._decode_body()
            for m, n in _launch_counts().items():
                self.metrics[m] += n - before[m]
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for m, n in self._graph_launches.items():
            self.metrics[m] += n

    def _capture(self) -> None:
        """Capture ``_decode_body`` into a CUDA graph. Every slot is parked
        for the warm-up (an eager run on a side stream, which builds and
        loads the kernels, creates the cuBLAS handles and loads lazy
        modules before capture) so its pool writes land in the scratch
        page, or, in the dense layout, at position 0 of every slot, which
        is saved beside the state; then both are restored. The wrappers'
        counts taken over the capture are what each replay launches."""
        t0 = time.perf_counter()
        state = (self._tok, self._pos, self._act, self._rem, self._t)
        if not self.paged:
            state += tuple(c[:, :, 0] for c in self.slots.cache.values())
        saved = [x.clone() for x in state]
        for x in state[:4]:
            x.zero_()
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._decode_body()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            alloc0 = torch.cuda.memory_allocated(self.device)
            res0 = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(graph):
                self._decode_body()
            self._graph_launches = {m: n - before[m]
                                    for m, n in _launch_counts().items()}
            self.metrics["graph_allocated_bytes"] = \
                torch.cuda.memory_allocated(self.device) - alloc0
            self.metrics["graph_reserved_bytes"] = \
                torch.cuda.memory_reserved(self.device) - res0
        finally:
            for x, s in zip(state, saved):
                x.copy_(s)
        self._graph = graph
        torch.cuda.synchronize(self.device)
        self.metrics["graph_captures"] += 1
        self.metrics["graph_capture_s"] += time.perf_counter() - t0

    def _read_history(self, length: int):
        """The one host sync of a horizon: its history rows as numpy
        (int64 [length, 3, B]; fp32 stats [length, 3, L, B] or None)."""
        bufs = [self._hist[:length]]
        if self._hist_stats is not None:
            bufs.append(self._hist_stats[:length])
        if self.device.type == "cuda":
            host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                    for b in bufs]
            for h, b in zip(host, bufs):
                h.copy_(b, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            bufs = host
        out = [b.numpy() for b in bufs]
        return out[0], (out[1] if len(out) > 1 else None)

    def _decode_horizon(self, length: int) -> None:
        """``length`` decode steps with no sync between them, one read of
        the history, then the host walk: emit tokens, finish slots at EOS
        or budget, abort faulted slots only."""
        t0 = time.perf_counter()
        self._t.zero_()
        for _ in range(length):
            self._step_once()
        hist, stats = self._read_history(length)
        self.metrics["decode_s"] += time.perf_counter() - t0
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
                    self._finish(slot, status="error",
                                 error="non-finite logits (per-slot tripwire)")
                    continue
                st = self._active[slot]
                req = st["req"]
                tok = int(toks[t, slot])
                st["generated"].append(tok)
                self.metrics["tokens_out"] += 1
                if len(st["generated"]) >= req.max_new_tokens or \
                        (req.eos_id is not None and tok == req.eos_id):
                    self._finish(slot)

    def _finish(self, slot: int, *, status: str = "ok",
                error: Optional[str] = None) -> None:
        st = self._active.pop(slot)
        res = self._results[st["req"].uid]
        res.tokens = list(st["generated"])
        res.decode_steps = len(res.tokens)
        res.complete = status == "ok"
        res.status, res.error = status, error
        # park the slot (the decode step has parked its device state
        # already): its table row is zeroed, so later decode writes of
        # the parked slot land in the scratch page; a dense slot is cleared
        if self.paged:
            self.pages.free(slot)
        else:
            self.slots.clear(slot)
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._act[slot] = False
        self._rem[slot] = 0
        self._free.append(slot)

    # -------------------------------------------------------------- metrics
    @staticmethod
    def _fresh_metrics() -> Dict[str, float]:
        return {"prefill_s": 0.0, "prefill_calls": 0, "prefill_tokens": 0,
                "decode_s": 0.0, "decode_steps": 0, "tokens_out": 0,
                "block_sparsity": 0.0, "head_sparsity": 0.0,
                "page_sparsity": 0.0, "stat_samples": 0, "page_samples": 0,
                "fum_kernel_launches": 0, "block_kernel_launches": 0,
                "graph_captures": 0, "graph_capture_s": 0.0,
                "graph_allocated_bytes": 0, "graph_reserved_bytes": 0}

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
        for name in _STAT_NAMES:
            if name in stats:
                x = stats[name]
                if isinstance(x, torch.Tensor):
                    x = x.cpu().numpy()
                m[name] += self._masked_mean(x, mask)
        m["page_samples"] += "page_sparsity" in stats
        m["stat_samples"] += 1

    def resolved_backend(self, phase: str) -> str:
        """Name of the backend the registry resolves for a serving phase
        ("prefill" | "decode"), from the same call constructor as
        ``attn_apply``, so the report cannot drift from the dispatch."""
        if phase not in ("prefill", "decode"):
            raise ValueError(f"phase must be prefill or decode, got "
                             f"{phase!r}")
        decode = phase == "decode"
        call = build_attn_call(self.cfg, mode=phase,
                               paged=self.paged and decode, per_slot=decode,
                               collect_stats=self.collect_stats,
                               kv_scale=self.kv_scale)
        return resolve_backend(call, self.attn_spec).name

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
        m["device"] = str(self.device)
        m["decode_horizon"] = self.horizon
        m["cuda_graph"] = self.cuda_graph
        m["attn_backend_prefill"] = self.resolved_backend("prefill")
        m["attn_backend_decode"] = decode = self.resolved_backend("decode")
        # the decode stage-3 implementation: the resolved backend's kernel
        # on the card, its plain version for CPU tensors; the FUM kernel's
        # scout view assumes the static grid, so absmax pools fall back
        # to the plain PyTorch stage (paged_hdp_decode's)
        stage3 = ("paged_hdp_decode" if decode == "pallas_paged_decode"
                  and self.kv_scale == "absmax" else decode)
        m["attn_decode_stage3"] = _STAGE3_IMPL.get(stage3, (stage3,) * 2)[
            self.device.type != "cuda"]
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
        else:
            m["cache_bytes"] = cache_bytes(self.slots.cache)
            m["cache_bytes_per_token"] = self.slots.bytes_per_token()
        return m
