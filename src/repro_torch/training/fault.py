"""Fault tolerance: watchdog, straggler detection, retry-with-restore.

Run-time failure model at 1000+ nodes:

* **Hangs** (network partition, dead host in a collective): a `Watchdog`
  thread fires when no heartbeat lands within `timeout_s`; the callback
  can dump state, request a checkpoint, or abort the process so the
  cluster scheduler reschedules it.
* **Stragglers** (thermal throttling, bad HBM, noisy neighbour):
  `StepTimer` keeps a rolling window of step wall-times and flags steps
  slower than `k` x the window median. On a real cluster the event log
  feeds eviction policy; here it is surfaced in training metrics. The
  MTTR lever is checkpoint cadence, not in-step recovery — collectives
  are synchronous, so a straggler *delays* but never corrupts a step.
* **Crashes**: `retry` re-runs a step function on transient errors with
  exponential backoff; combined with `CheckpointManager.restore_or` the
  training loop resumes from the last durable step (see launch/train.py).
* **Elasticity**: `elastic_mesh_shape` shrinks the data axis after
  permanent device loss; checkpoints store full logical arrays so
  `load_checkpoint(..., device=...)` restores onto whatever devices the
  caller runs with no format conversion.

PyTorch-port copy of ``repro.training.fault`` (line for line; ``retry``
classifies with the port's ``common.transient.is_transient``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import statistics
import threading
import time
from typing import Callable, Deque, List, Optional, Tuple, Union

from repro_torch.common.transient import TransientError, is_transient

__all__ = [
    "StragglerEvent", "StepTimer", "Watchdog", "retry",
    "elastic_mesh_shape", "TransientError", "is_transient",
]

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float

    @property
    def slowdown(self) -> float:
        return self.duration_s / max(self.median_s, 1e-9)


class StepTimer:
    """Rolling step-time statistics + straggler flagging."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 warmup: int = 3):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._n = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._n += 1
        if self._n > self.warmup:  # skip compile steps
            if len(self.window) >= 5:
                med = statistics.median(self.window)
                if dt > self.threshold * med:
                    ev = StragglerEvent(step, dt, med)
                    self.events.append(ev)
                    log.warning("straggler: step %d took %.3fs (%.1fx median"
                                " %.3fs)", step, dt, ev.slowdown, med)
            self.window.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.window:
            return {"steps_timed": self._n, "stragglers": len(self.events)}
        return {
            "steps_timed": self._n,
            "median_s": statistics.median(self.window),
            "p90_s": sorted(self.window)[int(0.9 * (len(self.window) - 1))],
            "stragglers": len(self.events),
            "worst_slowdown": max((e.slowdown for e in self.events),
                                  default=1.0),
        }


class Watchdog:
    """Fires `on_timeout` if `beat()` is not called within `timeout_s`.

    Used around blocking device work: a hung collective never returns, so
    only an external thread can observe it.
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Callable[[], None],
                 poll_s: float = 0.5):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.poll_s = poll_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()

    def _run(self) -> None:
        while not self._stop.is_set():
            if time.monotonic() - self._last > self.timeout_s:
                if not self._fired:
                    self._fired = True
                    log.error("watchdog: no heartbeat for %.1fs",
                              self.timeout_s)
                    try:
                        self.on_timeout()
                    except Exception:  # noqa: BLE001 - never kill the thread
                        log.exception("watchdog callback failed")
            self._stop.wait(self.poll_s)

    @property
    def fired(self) -> bool:
        return self._fired

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def retry(fn: Callable, *args, retries: int = 2, backoff_s: float = 0.5,
          transient: Union[Tuple[type, ...],
                           Callable[[BaseException], bool]] = is_transient,
          on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Run `fn(*args)`, retrying transient failures with backoff.

    `transient` is either a tuple of exception types or a predicate; the
    default is the shared :func:`repro_torch.common.is_transient` taxonomy, so
    programming errors (shape mismatches, donated handles, injected
    faults) fail fast instead of being retried with backoff — only
    failures expected under load (collective timeouts, OS errors, typed
    `TransientError`s) burn retry budget.

    `on_retry(attempt, exc)` runs before each retry — the hook where the
    launcher restores from the last checkpoint (device state after a
    failed collective is undefined; params must be reloaded).
    """
    if isinstance(transient, tuple):
        types = transient
        matches = lambda e: isinstance(e, types)  # noqa: E731
    else:
        matches = transient
    attempt = 0
    while True:
        try:
            return fn(*args)
        except Exception as e:  # noqa: PERF203, BLE001 - classified below
            if not matches(e):
                raise
            attempt += 1
            if attempt > retries:
                raise
            log.warning("transient failure (%s); retry %d/%d", e, attempt,
                        retries)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2 ** (attempt - 1)))


def elastic_mesh_shape(n_devices: int, model_parallel: int,
                       pod: int = 1) -> Tuple[int, ...]:
    """Largest (pod, data, model) grid that fits surviving devices.

    The model axis is preserved (weights are sharded over it — shrinking
    it requires resharding weights, which the elastic checkpoint handles,
    but the *preferred* degradation is dropping data-parallel replicas).
    """
    if model_parallel <= 0 or n_devices < model_parallel:
        raise ValueError("not enough devices for the model-parallel group")
    data = n_devices // (model_parallel * pod)
    if data < 1:
        raise ValueError("not enough devices for one data replica")
    return (pod, data, model_parallel) if pod > 1 else (data, model_parallel)
