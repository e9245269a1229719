"""Batched serving engine with HDP over the int8 block-paged pool.

PyTorch counterpart of the greedy core of ``repro.serving.Engine`` for
dense transformer families:

* **batched bucketed prefill** — queued requests are grouped by pad
  bucket and stacked into one prefill per group (each prompt right-padded
  with its last token); the dense request cache it fills is scattered
  into the slot's freshly allocated pool pages;
* **per-token greedy decode** — every step runs one decode over all
  ``max_batch`` slots; inactive slots get a zeroed table row, token 0
  and position 0, so their writes land in the scratch page. Each layer's
  attention goes through the backend the registry resolves for the
  engine's ``attn`` spec: by default the gather-free FUM kernel
  (``pallas_paged_decode``), or the block-sparse kernel on a densified
  gather (``attn="pallas_hdp_block"``);
* EOS and budget handling; a finished request frees its pages at once.

Not ported yet (ROADMAP.md section 1): chunked prefill for prompts
longer than the largest bucket (they raise ``ValueError``), the fused
decode horizon, the prefix cache, speculative decode, the stream
scheduler, fault handling and tensor parallelism.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.serving.kv_cache import KV_DTYPE, PagedKVCache


#: decode backend -> its stage-3 implementation (on the card, on the CPU)
_STAGE3_IMPL = {
    "pallas_paged_decode": ("cuda:hdp_paged_fum_decode",
                            "plain:hdp_paged_fum_decode_ref"),
    "pallas_hdp_block": ("cuda:hdp_block_sparse_attention",
                         "plain:hdp_block_sparse_attention_plain"),
}


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
    cfg: ModelConfig (dense family with HDP enabled).
    params: model parameter dict; drawn from ``seed`` when None.
    device: "cuda" (default) or "cpu"; CUDA raises when absent.
    max_batch: decode slot count.
    max_len: longest prompt + generation a slot holds.
    prefill_buckets: pad-to lengths of the batched prefill.
    collect_stats: aggregate HDP block/head/page sparsity.
    attn: AttnSpec, or a backend name or family tag, selecting the
        attention backend per phase; None uses the default spec (which
        honors REPRO_ATTN_BACKEND).
    """

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 device="cuda", max_batch: int = 4, max_len: int = 128,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 collect_stats: bool = False,
                 attn: Union[AttnSpec, str, None] = None):
        if isinstance(attn, str):
            attn = AttnSpec(backend=attn)
        self.attn_spec = attn if attn is not None else default_spec()
        self.device = resolve_device(device)
        hdp = cfg.hdp
        if hdp is None or not hdp.enabled:
            raise NotImplementedError(
                "HDP-off serving is not ported yet (ROADMAP.md section 1)")
        if hdp.calib != "none":
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
        for phase in ("prefill", "decode"):
            try:
                self.resolved_backend(phase)
            except KeyError as e:
                raise ValueError(f"{phase}: {e.args[0]}") from None
        if params is None:
            params = registry.init_params(cfg, seed, self.device)
        self.params = params
        self.pages = PagedKVCache(cfg, max_batch, max_len, device=self.device)
        self._free = list(range(max_batch))
        self._active: Dict[int, Dict[str, Any]] = {}   # slot -> state
        self._results: Dict[int, Result] = {}
        self._queue: List[Request] = []
        self._last_tok = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self.metrics: Dict[str, float] = self._fresh_metrics()

    # --------------------------------------------------------------- public
    def submit(self, req: Request) -> None:
        """Enqueue a request."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt+generation exceeds max_len")
        if plen > self.buckets[-1]:
            raise ValueError(
                f"request {req.uid}: prompt of {plen} tokens exceeds the "
                f"largest prefill bucket ({self.buckets[-1]}); chunked "
                "prefill is not ported yet")
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

    def step(self) -> None:
        """Admit what fits, then one decode step over all slots."""
        self._admit()
        if self._active:
            self._decode_step()

    # ------------------------------------------------------------ admission
    def _bucket_for(self, n: int) -> int:
        return next(b for b in self.buckets if n <= b)   # submit checked n

    def _admit(self) -> None:
        n = min(len(self._queue), len(self._free))
        if n == 0:
            return
        take = [self._queue.pop(0) for _ in range(n)]
        groups: Dict[int, List[Request]] = {}
        for req in take:
            groups.setdefault(self._bucket_for(len(req.prompt)), []).append(req)
        jobs = [(b, groups[b][i:i + self.max_batch])
                for b in sorted(groups)
                for i in range(0, len(groups[b]), self.max_batch)]
        try:
            while jobs:
                bucket, reqs = jobs.pop(0)
                self._prefill_group(bucket, reqs)
        except BaseException:
            for _, reqs in jobs:                 # never-started groups
                self._queue[:0] = reqs
            raise

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
            for req, slot in zip(reqs, slots):
                self.pages.alloc(slot, len(req.prompt) + req.max_new_tokens)
            t0 = time.perf_counter()
            cache = registry.init_cache(self.cfg, nb, bucket,
                                        device=self.device)
            _, cache, stats = registry.apply_prefill(
                self.cfg, self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)}, cache,
                collect_stats=self.collect_stats, attn=self.attn_spec)
            for r, slot in enumerate(slots):
                self.pages.insert(cache, slot, row=r)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
        except BaseException:
            # roll admission back: nothing leaks, nothing drops
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

    def _activate(self, req: Request, slot: int, prefill_s: float) -> None:
        """Arm a slot: the first decode step replays the last prompt token
        at its own position (an idempotent K/V rewrite) and yields the
        first generated token."""
        self._active[slot] = {"req": req, "generated": []}
        self._results[req.uid] = Result(req.uid, len(req.prompt), [],
                                        prefill_s=prefill_s)
        self._last_tok[slot] = int(req.prompt[-1])
        self._pos[slot] = len(req.prompt) - 1

    # --------------------------------------------------------------- decode
    @torch.no_grad()
    def _decode_step(self) -> None:
        active = np.zeros(self.max_batch, bool)
        active[list(self._active)] = True
        act_dev = torch.from_numpy(active).to(self.device)
        table = torch.where(act_dev[:, None], self.pages.table(), 0)
        tok = torch.from_numpy(self._last_tok[:, None]).to(self.device)
        pos = torch.from_numpy(self._pos[:, None]).to(self.device)
        t0 = time.perf_counter()
        logits, _, stats = registry.apply_decode(
            self.cfg, self.params, tok, self.pages.cache, pos,
            collect_stats=self.collect_stats, page_table=table,
            attn=self.attn_spec)
        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1)
        # per-slot tripwire: a non-finite logit row means this request's
        # state is poisoned; abort only that request
        bad = ~torch.isfinite(last).all(dim=-1)
        nxt_np, bad_np = nxt.cpu().numpy(), bad.cpu().numpy()
        self._record_stats(stats, mask=active)
        self.metrics["decode_s"] += time.perf_counter() - t0
        self.metrics["decode_steps"] += 1
        for slot in list(self._active):
            st = self._active[slot]
            req = st["req"]
            if bad_np[slot]:
                self._finish(slot, status="error",
                             error="non-finite logits (per-slot tripwire)")
                continue
            t = int(nxt_np[slot])
            st["generated"].append(t)
            self.metrics["tokens_out"] += 1
            self._last_tok[slot] = t
            self._pos[slot] += 1
            if len(st["generated"]) >= req.max_new_tokens or \
                    (req.eos_id is not None and t == req.eos_id):
                self._finish(slot)

    def _finish(self, slot: int, *, status: str = "ok",
                error: Optional[str] = None) -> None:
        st = self._active.pop(slot)
        res = self._results[st["req"].uid]
        res.tokens = list(st["generated"])
        res.decode_steps = len(res.tokens)
        res.complete = status == "ok"
        res.status, res.error = status, error
        # park the slot: its table row is zeroed, so later decode writes
        # of the parked slot land in the scratch page
        self.pages.free(slot)
        self._last_tok[slot] = 0
        self._pos[slot] = 0
        self._free.append(slot)

    # -------------------------------------------------------------- metrics
    @staticmethod
    def _fresh_metrics() -> Dict[str, float]:
        return {"prefill_s": 0.0, "prefill_calls": 0, "prefill_tokens": 0,
                "decode_s": 0.0, "decode_steps": 0, "tokens_out": 0,
                "block_sparsity": 0.0, "head_sparsity": 0.0,
                "page_sparsity": 0.0, "stat_samples": 0, "page_samples": 0}

    @staticmethod
    def _masked_mean(x, mask) -> float:
        """Mean over real samples: decode leaves are [L, B] and the active
        mask drops parked slots; prefill leaves ([L]) pass through."""
        x = np.asarray(x)
        if mask is not None and x.ndim >= 2 and x.shape[-1] == len(mask):
            x = x[..., mask]
        return float(np.mean(x))

    def _record_stats(self, stats, mask=None) -> None:
        """Accumulate one stats sample (tensor leaves with a layer dim)."""
        if stats is None:
            return
        m = self.metrics
        for name in ("block_sparsity", "head_sparsity", "page_sparsity"):
            if name in stats:
                m[name] += self._masked_mean(stats[name].cpu().numpy(), mask)
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
        call = build_attn_call(self.cfg, mode=phase, paged=decode,
                               per_slot=decode,
                               collect_stats=self.collect_stats)
        return resolve_backend(call, self.attn_spec).name

    def summary(self) -> Dict[str, Any]:
        m = dict(self.metrics)
        if m["decode_s"] > 0:
            m["decode_tok_s"] = m["tokens_out"] / m["decode_s"]
        if m["stat_samples"]:
            m["block_sparsity"] /= m["stat_samples"]
            m["head_sparsity"] /= m["stat_samples"]
        if m["page_samples"]:
            m["page_sparsity"] /= m["page_samples"]
        m["completed"] = sum(r.complete for r in self._results.values())
        m["device"] = str(self.device)
        m["attn_backend_prefill"] = self.resolved_backend("prefill")
        m["attn_backend_decode"] = decode = self.resolved_backend("decode")
        # the decode stage-3 implementation: the resolved backend's kernel
        # on the card, its plain version for CPU tensors
        m["attn_decode_stage3"] = _STAGE3_IMPL.get(decode, (decode,) * 2)[
            self.device.type != "cuda"]
        m["fum_kernel_launches"] = hdp_paged_fum_decode.launches
        m["block_kernel_launches"] = hdp_block_sparse_attention.launches
        m["kv_dtype"] = KV_DTYPE
        m["cache_bytes"] = self.pages.active_bytes(self.pages.peak_pages)
        m["cache_bytes_pool"] = self.pages.pool_bytes()
        m["cache_bytes_per_token"] = self.pages.bytes_per_token()
        m["pages_peak"] = self.pages.peak_pages
        m["pages_in_use"] = self.pages.pages_in_use
        m["page_size"] = self.pages.page_size
        return m
