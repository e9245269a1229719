"""Data-parallel engine replicas behind one dispatching front-end.

PyTorch-port copy of ``repro.serving.replica``, line for line. N
complete engines, each with its own page pool, slot buffers, CUDA
graphs, scheduler and prefix cache (all on the one card), are served
through a single submit/step/serve surface. Replicas share one params
dict (the same tensors, not copies), so which replica serves a request
never changes its tokens — dispatch is a pure load/locality decision
(below it, tensor parallelism shards one engine's pool over the ranks of
a serving mesh's "model" axis: ``distribution.tp``; under it every rank
holds every replica, each of them sharded, and dispatches alike):

* **prefix affinity** first: the replica whose radix prefix cache holds
  the longest cached prefix of the prompt (a read-only ``peek``) wins —
  re-dispatching a shared-prefix request to the replica that already
  holds the pages turns a cold prefill into a hot one;
* **least-loaded** otherwise: the replica with the fewest pending
  requests (active + queued + scheduler backlog), ties broken by
  replica index for determinism.

``serve`` merges the per-replica completion streams by driving every
replica with pending work one step per iteration and yielding Results
in global finish order.

Failover
--------
Each replica carries a health state (``"up"``/``"dead"``). ``step``
health-checks every member: a step that raises a transient error burns
one of ``step_retries`` strikes and is retried next fleet step; a
non-transient error (or exhausted strikes) kills the replica. A dead
replica's in-flight work — active decode slots (rewound to
recompute-resume requests, exactly like scheduler preemption), queued
and mid-prefill requests — is re-dispatched onto the survivors
**exactly once** per request: a request whose second home also dies is
failed with a typed ``Result(status="error")`` rather than bounced
forever. The dead engine's host queues are cleared so the merged
result stream can never resurrect its stale shells; its device memory
(pool, slot buffers, graphs) and allocator are abandoned as-is until
the set is dropped (the process-level analogue of a lost host), and
its graphs never replay again. Because replicas share params and
decode is greedy, a failed-over request's tokens are those of an
uninterrupted run up to its failover; after it, the recompute resume
re-prefills the generated tokens, which in bf16 (or with HDP's
block-tile prefill scout) may round apart from the decode steps that
made them (ROADMAP.md section 3, as for preemption) — the prefix cache
turns the recompute into a hot prefill when the survivor has seen the
prefix.

A ``FaultInjector`` shared across the fleet (``build(faults=...)`` or
``REPRO_FAULT_PLAN``) drives deterministic chaos: ``kill@S:replica=R``
events are consumed here, per-engine events inside the members.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.common.transient import is_transient
from repro_torch.serving.engine import Engine, Request, Result
from repro_torch.serving.faults import coerce_injector


class ReplicaSet:
    """N engines, one front-end. See module docstring for dispatch."""

    def __init__(self, engines: Sequence[Engine], *, faults=None,
                 step_retries: int = 1):
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        self.engines: List[Engine] = list(engines)
        self._home: Dict[int, Engine] = {}      # uid -> serving replica
        self._finish_log: List[int] = []        # uids in global finish order
        self._emitted_per_eng = [0] * len(self.engines)
        # fleet-level fault injection (kill events); defaults to the
        # members' shared injector so one plan drives the whole stack
        self.faults = (coerce_injector(faults, env=False)
                       or self.engines[0].faults)
        self.step_retries = step_retries
        self.health: List[str] = ["up"] * len(self.engines)
        self._strikes = [0] * len(self.engines)
        # reported only: no dispatch or health decision reads a clock, so
        # the ranks of tensor-parallel replicas cannot part on one
        self._last_step_s = [0.0] * len(self.engines)
        self._failed_over: Set[int] = set()     # uids moved once already
        self.failovers = 0                      # replicas declared dead
        self.requests_failed_over = 0           # requests re-dispatched
        self._step_no = 0

    @classmethod
    def build(cls, cfg, dp: int, *, params=None, seed: int = 0, faults=None,
              step_retries: int = 1, **engine_kw) -> "ReplicaSet":
        """Build ``dp`` replicas sharing ONE params dict.

        The first engine draws the params from ``seed`` (or adopts
        ``params``); the rest reuse the same dict, whose tensors are
        shared, not copied, so every replica is token-identical by
        construction. Per-engine kwargs (device, attn, spec_decode, ...)
        apply to every replica alike. ``faults`` (a plan/spec/injector;
        env fallback ``REPRO_FAULT_PLAN``) is coerced ONCE and shared by
        the fleet and every member, so each scheduled event fires
        exactly once fleet-wide.
        """
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        inj = coerce_injector(faults)
        first = Engine(cfg, params, seed=seed, faults=inj, **engine_kw)
        rest = [Engine(cfg, first.params, faults=inj, **engine_kw)
                for _ in range(dp - 1)]
        return cls([first] + rest, faults=inj, step_retries=step_retries)

    # -------------------------------------------------------------- dispatch
    def _healthy(self) -> List[Engine]:
        return [e for i, e in enumerate(self.engines)
                if self.health[i] == "up"]

    def _pick(self, req: Request) -> Engine:
        alive = self._healthy()
        if not alive:
            raise RuntimeError("ReplicaSet: every replica is dead")
        best, best_hit = None, 0
        for eng in alive:
            if eng.prefix is None:
                continue
            hit = eng.prefix.peek(req.prompt, align=eng._page_align)
            if hit > best_hit:
                best, best_hit = eng, hit
        if best is not None:
            return best
        return min(alive, key=lambda e: (e._n_pending(),
                                         self.engines.index(e)))

    def submit(self, req: Request, **kw) -> Engine:
        """Dispatch ``req`` to a healthy replica (returned for
        introspection); ``deadline_s``/``max_queue_wait_s`` pass through
        to ``Engine.submit``."""
        eng = self._pick(req)
        self._home[req.uid] = eng
        eng.submit(req, **kw)
        return eng

    def cancel(self, uid: int, **kw) -> bool:
        """Cancel ``uid`` on whichever replica is serving it."""
        eng = self._home.get(uid)
        return eng.cancel(uid, **kw) if eng is not None else False

    # --------------------------------------------------------------- health
    def _kill(self, idx: int, reason: str) -> None:
        """Declare replica ``idx`` dead and fail its work over.

        In-flight requests move to survivors exactly once each; a
        request orphaned a second time gets a typed error Result (on the
        corpse's finish stream, which the merged drain still reads).
        The corpse's host queues are then emptied so ``_n_pending`` /
        ``results()`` never see its stale state again; device tensors,
        graphs and the page allocator are abandoned un-freed, like a lost
        host.
        """
        if self.health[idx] != "up":
            return
        self.health[idx] = "dead"
        self.failovers += 1
        eng = self.engines[idx]
        moved: List[Request] = [
            Engine._make_resume(st["req"], st["generated"])
            for _, st in sorted(eng._active.items())]
        moved += eng._pending_requests()
        eng._active.clear()
        eng._queue.clear()
        if eng.sched is not None:
            eng.sched.waiting.clear()
            eng.sched._chunk = None
        for req in moved:
            # drop the corpse's partial bookkeeping for the request so
            # the survivor's Result is the only one left standing
            eng._results.pop(req.uid, None)
            eng._t_submit.pop(req.uid, None)
            eng._deadlines.pop(req.uid, None)
            if req.uid in self._failed_over:
                eng._fail_request(
                    req, status="error",
                    error=f"lost twice: replica {idx} died ({reason}) "
                          "after an earlier failover")
                continue
            self._failed_over.add(req.uid)
            target = self._pick(req)
            self._home[req.uid] = target
            target.submit(req)
            self.requests_failed_over += 1

    # ----------------------------------------------------------------- drive
    def _n_pending(self) -> int:
        return sum(e._n_pending() for e in self._healthy())

    def _drain_finished(self) -> List[int]:
        """Collect uids finished since the last drain, in finish order
        (per replica; interleaved round-robin across replicas)."""
        fresh: List[int] = []
        for i, eng in enumerate(self.engines):
            while self._emitted_per_eng[i] < len(eng._finished):
                fresh.append(eng._finished[self._emitted_per_eng[i]])
                self._emitted_per_eng[i] += 1
        self._finish_log.extend(fresh)
        return fresh

    def step(self) -> int:
        """One step of every healthy replica with pending work; returns
        how many replicas stepped. Fires due replica-kill fault events
        first; a member whose step raises is retried (transient, within
        ``step_retries`` strikes) or killed and failed over."""
        step_no = self._step_no
        self._step_no += 1
        if self.faults is not None:
            for r in self.faults.kills(step_no):
                if 0 <= r < len(self.engines):
                    self._kill(r, f"injected kill at fleet step {step_no}")
        ran = 0
        for i, eng in enumerate(self.engines):
            if self.health[i] != "up" or not eng._n_pending():
                continue
            t0 = time.perf_counter()
            try:
                eng.step()
            except Exception as e:  # noqa: BLE001 - classified below
                if is_transient(e) and self._strikes[i] < self.step_retries:
                    self._strikes[i] += 1
                    continue
                self._kill(i, f"{type(e).__name__}: {e}")
                continue
            self._strikes[i] = 0
            self._last_step_s[i] = time.perf_counter() - t0
            ran += 1
        return ran

    def run(self, max_steps: int = 10_000, *,
            strict: bool = False) -> Dict[int, Result]:
        """Drive every replica until all submitted requests complete."""
        steps = 0
        while self._n_pending() and steps < max_steps:
            self.step()
            steps += 1
        self._drain_finished()
        out: Dict[int, Result] = {}
        for i, eng in enumerate(self.engines):
            if (steps >= max_steps and self.health[i] == "up"
                    and eng._n_pending()):
                out.update(eng.run(max_steps=0, strict=strict))
            else:
                out.update(eng.results())
        return out

    def serve(self, reqs: Optional[Iterable[Request]] = None, *,
              max_steps: int = 10_000):
        """Merged streaming serve loop: yields each Result as it
        completes, across every replica; more requests may be submitted
        between yields."""
        if reqs is not None:
            for r in reqs:
                self.submit(r)
        self._drain_finished()      # don't re-yield pre-loop results
        steps = 0
        while self._n_pending():
            if steps >= max_steps:
                raise RuntimeError(
                    f"ReplicaSet.serve: step budget {max_steps} exhausted "
                    f"with {self._n_pending()} request(s) unfinished")
            self.step()
            steps += 1
            for uid in self._drain_finished():
                yield self._home[uid]._results[uid]

    # ------------------------------------------------------------- reporting
    def results(self) -> Dict[int, Result]:
        out: Dict[int, Result] = {}
        for eng in self.engines:
            out.update(eng.results())
        return out

    def reset_metrics(self) -> None:
        for eng in self.engines:
            eng.reset_metrics()

    def summary(self) -> Dict[str, object]:
        """Merged summary: fleet totals plus the per-replica summaries."""
        subs = [e.summary() for e in self.engines]
        m: Dict[str, object] = {
            "dp": len(self.engines),
            "tp": self.engines[0].tp,
            "tokens_out": sum(s.get("tokens_out", 0) for s in subs),
            "decode_s": sum(s.get("decode_s", 0.0) for s in subs),
            "prefill_s": sum(s.get("prefill_s", 0.0) for s in subs),
            "requests_per_replica": [
                len(e._results) for e in self.engines],
            # per-replica health + load observability (serve CLI output)
            "health": list(self.health),
            "failovers": self.failovers,
            "requests_failed_over": self.requests_failed_over,
            "replica_queue_depth": [e._n_pending() for e in self.engines],
            "replica_inflight": [len(e._active) for e in self.engines],
            "replica_last_step_s": list(self._last_step_s),
            "replicas": subs,
        }
        if m["decode_s"]:
            m["decode_tok_s"] = m["tokens_out"] / m["decode_s"]
        if self.faults is not None:
            m["fault_plan"] = self.faults.plan.spec
            m["faults_fired"] = len(self.faults.fired)
        for key in ("mesh_shape", "cache_bytes_pool_per_shard",
                    "collective_bytes_per_layer", "kv_dtype", "kv_scale"):
            if key in subs[0]:
                m[key] = subs[0][key]
        return m
