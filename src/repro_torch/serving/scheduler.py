"""Continuous-batching stream scheduler over the engine's slot and page
machinery. PyTorch-port counterpart of ``repro.serving.scheduler``, line
for line: the scheduler is pure host-side policy, so only its imports
differ from the reference's.

`StreamScheduler` turns the engine's fixed-wave admission into a
streaming serve loop. It owns the waiting queue and runs once per engine
step (``tick``), between decode horizons or speculative rounds, doing
three things:

* **Token-budget admission.** A waiting request is admitted only when a
  decode slot is free AND the page pool can hold its whole footprint
  (prompt + output budget, via ``Engine._pages_for``), counting pages an
  LRU eviction could reclaim (``RadixPrefixCache.evictable_pages``) as
  capacity. When the head of the queue does not fit, admission stops:
  head-of-line blocking is deliberate, since skipping ahead to smaller
  requests forever would starve big ones. Finished slots free their
  pages mid-run (``Engine._finish``), so a queued request prefills into
  the vacated slot at the very next tick: in-flight slot recycling, no
  drain barrier between "waves".

* **Prefix-cache-aware ordering.** With the radix tree enabled, waiting
  requests are ordered highest priority first, then biggest cached
  prefix first each tick (``RadixPrefixCache.peek``, a ref-free probe,
  so the hit and miss counters stay honest), FIFO within ties. A hit
  both prefills less and needs fewer fresh pages; the budget check uses
  the peeked hit to charge only the fresh (unshared) pages.

* **Chunked prefill interleaved with decode.** A long cold prompt
  (longer than the largest prefill bucket) is not prefilled in one
  blocking loop: the scheduler opens an incremental prefill
  (``Engine._begin_stream_prefill`` reserves the slot and pages up
  front, so completion is guaranteed) and advances it by at most
  ``prefill_chunk_tokens`` per tick, so the running batch keeps decoding
  between chunks and shorter requests keep being admitted around it.
  One interleaved prefill runs at a time; it runs the very chunk steps a
  one-shot chunked prefill runs, so its tokens are identical.

A **watchdog** closes the loop: if the engine makes no progress (no
token decoded, nothing admitted, no prefill chunk advanced) for
``watchdog_steps`` consecutive steps (or ``watchdog_s`` wall seconds)
while requests are still waiting, the stalled queue head is *shed* as a
per-request ``Result(status="error")`` and serving continues. After
``watchdog_escalation`` sheds the next trip raises `WatchdogError`:
repeated stalls mean the engine itself is wedged, not one bad request.

**Preempt-and-restore** handles the opposite starvation: when the queue
head has waited ``preempt_after`` consecutive no-admission ticks, the
scheduler may preempt a strictly-lower-priority *running* request
(recompute: free its slot and non-shared pages, requeue it with its
generated tokens folded into the prompt) so the head admits instead of
blocking forever. Greedy decode plus the chunked-prefill equivalence
make the victim's resume give the tokens of an uninterrupted run.

Every device-touching action (prefill, page reservation, slot install,
the writes to the decode graph's static buffers) goes through the
engine's admission paths, so batched bucketed prefill, prefix-hit
serving, COW and the unwind and requeue invariants are reused, not
reimplemented.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from repro_torch.common.transient import TransientError
from repro_torch.serving.allocator import PoolExhausted

if TYPE_CHECKING:  # import cycle: engine constructs the scheduler
    from repro_torch.serving.engine import Engine, Request


class WatchdogError(RuntimeError):
    """The streaming serve loop stalled with requests still pending."""


class QueueFull(TransientError):
    """``submit()`` rejected: the waiting queue is at ``max_queue_depth``.

    Typed backpressure instead of unbounded queue growth; it is a
    `TransientError` — clients should back off and resubmit."""


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs for `StreamScheduler` (see the module docstring).

    prefill_chunk_tokens: interleaved-prefill token budget per engine
        step; None = one largest-bucket chunk per step. At least one
        chunk always runs per tick, so progress is guaranteed even when
        the budget is smaller than a chunk.
    order: "prefix" admits highest `Request.priority` first, then
        biggest peeked cache hit (FIFO among ties and whenever the
        prefix cache is off); "fifo" disables the reordering entirely.
    watchdog_steps / watchdog_s: consecutive no-progress engine steps /
        wall seconds with pending requests before the watchdog trips.
    watchdog_escalation: a watchdog trip sheds the stalled queue head as
        a per-request ``Result(status="error")`` and keeps serving; after
        this many sheds the next trip raises `WatchdogError` (0 = legacy
        loop-fatal on the first trip).
    max_queue_depth: bound on ``depth``; ``submit()`` past it raises
        `QueueFull`. None = unbounded (legacy).
    preempt_after: consecutive no-admission ticks with work waiting
        before a strictly-lower-priority running request may be
        preempted (recompute-requeued) to unblock the queue head.
        None disables preemption.
    """

    prefill_chunk_tokens: Optional[int] = None
    order: str = "prefix"
    watchdog_steps: int = 500
    watchdog_s: float = 120.0
    watchdog_escalation: int = 8
    max_queue_depth: Optional[int] = None
    preempt_after: Optional[int] = 4

    def __post_init__(self):
        if self.order not in ("prefix", "fifo"):
            raise ValueError(f"order must be 'prefix' or 'fifo', "
                             f"got {self.order!r}")
        if self.watchdog_steps < 1:
            raise ValueError(
                f"watchdog_steps must be >= 1, got {self.watchdog_steps}")
        if self.prefill_chunk_tokens is not None \
                and self.prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                             f"{self.prefill_chunk_tokens}")
        if self.watchdog_escalation < 0:
            raise ValueError(f"watchdog_escalation must be >= 0, got "
                             f"{self.watchdog_escalation}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{self.max_queue_depth}")
        if self.preempt_after is not None and self.preempt_after < 1:
            raise ValueError(f"preempt_after must be >= 1, got "
                             f"{self.preempt_after}")


@dataclasses.dataclass
class _Waiting:
    seq: int          # submission order — the FIFO tiebreak
    req: "Request"


class StreamScheduler:
    """Host-side admission policy driven by ``Engine.step`` (one tick
    per step). See the module docstring for the full contract."""

    def __init__(self, engine: "Engine", cfg: SchedulerConfig):
        self.eng = engine
        self.cfg = cfg
        self.waiting: List[_Waiting] = []
        self._seq = 0
        #: in-flight interleaved chunked prefill (Engine._begin_stream_prefill
        #: state dict), at most one at a time
        self._chunk: Optional[Dict[str, Any]] = None
        self._idle_steps = 0
        self._last_progress = time.perf_counter()
        #: watchdog trips so far (each shed one stalled request)
        self._trips = 0
        #: consecutive ticks the waiting head failed to admit — the
        #: preempt-and-restore trigger
        self._hol_ticks = 0
        #: admission log (uids in service-entry order) — tests pin the
        #: prefix-hit-first ordering through it
        self.admitted_uids: List[int] = []

    # -------------------------------------------------------------- queries
    @property
    def depth(self) -> int:
        """Requests not yet decoding: waiting + mid-interleaved-prefill."""
        return len(self.waiting) + (1 if self._chunk is not None else 0)

    @property
    def prefilling(self) -> bool:
        return self._chunk is not None

    def pending_requests(self) -> List["Request"]:
        reqs = [w.req for w in self.waiting]
        if self._chunk is not None:
            reqs.insert(0, self._chunk["req"])
        return reqs

    # ------------------------------------------------------------- enqueue
    def enqueue(self, req: "Request") -> None:
        self.waiting.append(_Waiting(self._seq, req))
        self._seq += 1

    # ---------------------------------------------------------------- tick
    def tick(self) -> bool:
        """One scheduling pass (runs before the step's decode): advance
        the in-flight chunked prefill, then admit what fits. Returns
        whether anything progressed (the watchdog's signal when no slot
        is decoding)."""
        progressed = self._advance_chunk()
        progressed |= self._admit()
        return progressed

    def watchdog(self, progressed: bool) -> None:
        """Called once per engine step with that step's overall progress
        (any decode token, admission, or prefill chunk). A trip — after
        ``watchdog_steps`` consecutive idle steps or ``watchdog_s`` idle
        wall seconds with requests pending — sheds the stalled queue
        head as a per-request failure and keeps serving; past
        ``watchdog_escalation`` sheds (or with escalation 0) it raises
        `WatchdogError` instead."""
        now = time.perf_counter()
        if progressed or self.depth == 0:
            self._idle_steps = 0
            self._last_progress = now
            return
        self._idle_steps += 1
        if self._idle_steps < self.cfg.watchdog_steps \
                and now - self._last_progress < self.cfg.watchdog_s:
            return
        uids = [r.uid for r in self.pending_requests()]
        msg = (f"stream scheduler stalled: no decode, admission or "
               f"prefill progress for {self._idle_steps} engine steps "
               f"({now - self._last_progress:.1f}s) with request(s) "
               f"{uids} pending — the queue head's slot/page footprint "
               f"can never be satisfied, or the engine is wedged")
        self._trips += 1
        esc = self.cfg.watchdog_escalation
        if esc == 0 or self._trips > esc or not self._shed_stalled(msg):
            raise WatchdogError(msg)
        self._idle_steps = 0
        self._last_progress = now

    def _shed_stalled(self, msg: str) -> bool:
        """Fail the stalled queue head (admission order) as a typed
        per-request error so the loop survives one bad request."""
        eng = self.eng
        if self.waiting:
            scored = [(w, self._hit_pages(w.req)) for w in self.waiting]
            if self.cfg.order == "prefix":
                scored.sort(key=lambda p: (-p[0].req.priority, -p[1],
                                           p[0].seq))
            w = scored[0][0]
            self.waiting.remove(w)
            victim = w.req
        elif self._chunk is not None:
            st = self._chunk
            self._chunk = None
            eng._abort_stream_prefill(st)
            victim = st["req"]
        else:
            return False
        eng.metrics["watchdog_shed"] += 1
        eng._fail_request(victim, status="error", error=f"watchdog: {msg}")
        return True

    # ------------------------------------------------------------- cancel
    def cancel(self, uid: int) -> Optional["Request"]:
        """Remove ``uid`` from the waiting queue or the in-flight chunked
        prefill (unwinding its slot/page reservation); returns the
        request so the engine can finish it with a typed Result, or
        None when ``uid`` is not queued here."""
        for w in self.waiting:
            if w.req.uid == uid:
                self.waiting.remove(w)
                return w.req
        if self._chunk is not None and self._chunk["req"].uid == uid:
            st = self._chunk
            self._chunk = None
            self.eng._abort_stream_prefill(st)
            return st["req"]
        return None

    # ----------------------------------------------------------- admission
    def _hit_pages(self, req: "Request") -> int:
        eng = self.eng
        if eng.prefix is None:
            return 0
        return eng.prefix.peek(req.prompt, align=eng._page_align)

    def _fresh_pages_for(self, req: "Request", hit: int) -> int:
        """Fresh pool pages an admission would need (shared hit pages are
        free; a full-prompt hit still COWs one page — mirrors
        Engine._serve_hit's reservation arithmetic)."""
        eng = self.eng
        if not eng.paged:
            return 0
        need = eng._pages_for(req)
        if hit:
            full = hit * eng.pages.page_size == len(req.prompt)
            need = need - hit + (1 if full else 0)
        return need

    def _is_long_cold(self, req: "Request", hit: int) -> bool:
        eng = self.eng
        return (hit == 0 and eng._can_chunk
                and len(req.prompt) > eng.buckets[-1])

    def _admit(self) -> bool:
        """Admit the largest prefix of the (ordered) waiting queue that
        fits the slot + page budget; long cold prompts open the
        interleaved prefill instead of a blocking one. Tracks head-of-
        line starvation and preempts lower-priority runners past the
        ``preempt_after`` threshold."""
        eng = self.eng
        if not self.waiting:
            self._hol_ticks = 0
            return False
        scored = [(w, self._hit_pages(w.req)) for w in self.waiting]
        if self.cfg.order == "prefix":
            scored.sort(key=lambda p: (-p[0].req.priority, -p[1], p[0].seq))
        if self.cfg.preempt_after is not None \
                and self._hol_ticks >= self.cfg.preempt_after:
            self._preempt_for(scored[0][0].req, scored[0][1])
        if not eng._free:
            self._hol_ticks += 1
            return False
        free = len(eng._free)
        cap = eng._pages_capacity() if eng.paged else None
        stage: List[_Waiting] = []
        progressed = False
        for w, hit in scored:
            if free == 0:
                break
            need = self._fresh_pages_for(w.req, hit)
            if cap is not None and need > cap:
                # token budget: the head blocks (skipping ahead forever
                # would starve it); retried next tick once slots finish
                eng.metrics["sched_deferred"] += 1
                break
            if self._is_long_cold(w.req, hit):
                if self._chunk is not None:
                    # one interleaved prefill at a time — shorter
                    # requests behind it keep flowing
                    continue
                # begin before dequeue: a reservation failure leaves the
                # request waiting instead of dropping it
                self._chunk = eng._begin_stream_prefill(w.req)
                self.waiting.remove(w)
                self._note_admitted(w.req.uid)
                progressed = True
            else:
                stage.append(w)
            free -= 1
            if cap is not None:
                cap -= need
        if stage:
            staged = {w.req.uid: w for w in stage}
            for w in stage:
                self.waiting.remove(w)
            eng._queue.extend(w.req for w in stage)
            try:
                eng._admit()
            except PoolExhausted:
                # the capacity estimate raced an eviction — the engine's
                # unwind already requeued the unadmitted requests, which
                # _reclaim below hands back to us for the next tick
                eng.metrics["sched_deferred"] += 1
            finally:
                returned = self._reclaim(staged)
            for w in stage:
                if w.req.uid not in returned:
                    self._note_admitted(w.req.uid)
                    progressed = True
        if progressed:
            self._hol_ticks = 0
        else:
            self._hol_ticks += 1
        return progressed

    # ---------------------------------------------- preempt-and-restore
    def _preempt_for(self, head: "Request", hit: int) -> bool:
        """Preempt strictly-lower-priority running requests until
        ``head`` fits (vLLM-style recompute): each victim frees its slot
        and non-shared pages and requeues with its generated tokens
        folded into the prompt, so its eventual resume — a plain
        re-admission through prefill — is byte-identical, and cheap
        while the prefix cache still holds the victim's pages."""
        eng = self.eng
        preempted = False
        while True:
            need = self._fresh_pages_for(head, hit)
            cap = eng._pages_capacity() if eng.paged else None
            if eng._free and (cap is None or need <= cap):
                break
            slot = eng._preempt_victim(head.priority)
            if slot is None:
                break
            self.enqueue(eng._preempt(slot))
            preempted = True
        if preempted:
            self._hol_ticks = 0
        return preempted

    def _reclaim(self, staged: Dict[int, _Waiting]) -> set:
        """Move whatever the engine unwound back to the waiting head,
        preserving original submission order; returns the unwound uids."""
        if not self.eng._queue:
            return set()
        back = []
        for req in self.eng._queue:
            w = staged.get(req.uid)
            back.append(w if w is not None else _Waiting(self._seq, req))
        self.eng._queue.clear()
        self.waiting[:0] = back
        return {w.req.uid for w in back}

    def _note_admitted(self, uid: int) -> None:
        self.admitted_uids.append(uid)
        m = self.eng.metrics
        m["sched_admitted"] += 1
        if m["decode_steps"] > 0:
            # decode already ran: this admission filled a slot vacated
            # mid-run — the continuous-batching recycle the bench pins
            m["sched_recycled"] += 1
            # a recycled slot changes the shape mix the engine serves;
            # give pending cost-policy probes a chance to settle before
            # the refilled batch decodes (no-op under the static policy;
            # the tick runs before the step's decode, so never inside a
            # graph capture)
            self.eng._maybe_retune()

    # ---------------------------------------------- interleaved prefill
    def _advance_chunk(self) -> bool:
        """Run up to ``prefill_chunk_tokens`` of the in-flight prefill
        (at least one chunk), installing + activating it when done."""
        if self._chunk is None:
            return False
        eng = self.eng
        budget = self.cfg.prefill_chunk_tokens or eng.buckets[-1]
        st = self._chunk
        if eng._active:
            # a prefill slice about to run under a live decode batch —
            # the interleaving the chunked-prefill satellite tests pin
            eng.metrics["sched_interleaved_steps"] += 1
        try:
            done = eng._advance_stream_prefill(st, budget)
        except BaseException:
            self._chunk = None
            eng._abort_stream_prefill(st)
            if not st.get("installed"):
                self.waiting.insert(0, _Waiting(self._seq, st["req"]))
            raise
        if done:
            self._chunk = None
        return True
