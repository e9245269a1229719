"""Deterministic fault injection for the serving stack.

PyTorch-port copy of ``repro.serving.faults`` (the same grammar, events
and error messages, so a spec parses alike in both packages), kept here
so that the port imports nothing of the JAX package.

A :class:`FaultPlan` is a schedule of failures pinned to engine step
numbers, parsed from a compact spec string (CLI ``--fault-plan`` or the
``REPRO_FAULT_PLAN`` env var)::

    kind@step[:key=value[,key=value...]][;kind@step...]

Kinds:

``exhaust@S``
    The next page reservation at or after step ``S`` raises
    :class:`~repro_torch.serving.allocator.PoolExhausted` (the stream
    scheduler defers and retries; static admission propagates it).
``error@S``
    Step ``S`` raises :class:`InjectedFault` from inside the decode
    (or speculative round's) call bracket, after the NaN mask is
    written and before the graph replays: the engine unwinds what the
    step wrote, so it stays usable.
``nan@S:uid=U``
    Request ``U``'s logits are forced to NaN at the first decode/verify
    step at or after ``S`` where it is active, tripping the per-slot
    tripwire (that request errors; batchmates must be unaffected).
``slow@S:s=0.05``
    Sleep ``s`` seconds at the top of step ``S`` (straggler).
``kill@S:replica=R``
    :class:`~repro_torch.serving.replica.ReplicaSet` marks replica ``R`` dead
    before stepping at fleet step ``S`` and fails its work over.

Every event fires **once**, at the first opportunity at-or-after its
scheduled step, and is recorded in :attr:`FaultInjector.fired` — the
plan is a consumable schedule, not a rate. Engines sharing one
injector (``ReplicaSet.build``) therefore see each event exactly once
fleet-wide; engines constructed with separate injectors each consume
their own copy of the plan.

:class:`InjectedFault` is deliberately **not** a
:class:`~repro_torch.common.transient.TransientError`: injected faults model
hard failures, so retry layers must not paper over them.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Union

FAULT_ENV = "REPRO_FAULT_PLAN"

_KINDS = ("exhaust", "error", "nan", "slow", "kill")


class InjectedFault(RuntimeError):
    """A failure raised on purpose by the fault-injection harness."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: ``kind`` at engine/fleet step ``step``."""

    kind: str
    step: int
    uid: Optional[int] = None       # nan: target request uid
    replica: Optional[int] = None   # kill: target replica index
    seconds: float = 0.0            # slow: sleep duration

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "nan" and self.uid is None:
            raise ValueError("nan fault needs :uid=<request uid>")
        if self.kind == "kill" and self.replica is None:
            raise ValueError("kill fault needs :replica=<index>")
        if self.kind == "slow" and self.seconds <= 0:
            raise ValueError("slow fault needs :s=<seconds> > 0")

    @property
    def spec(self) -> str:
        parts = []
        if self.uid is not None:
            parts.append(f"uid={self.uid}")
        if self.replica is not None:
            parts.append(f"replica={self.replica}")
        if self.seconds:
            parts.append(f"s={self.seconds:g}")
        tail = f":{','.join(parts)}" if parts else ""
        return f"{self.kind}@{self.step}{tail}"


def _parse_event(item: str) -> FaultEvent:
    head, _, tail = item.partition(":")
    kind, at, step = head.partition("@")
    if not at or not step:
        raise ValueError(f"fault item {item!r} is not 'kind@step[:k=v,..]'")
    kw: Dict[str, Union[int, float]] = {}
    for pair in filter(None, tail.split(",")):
        key, eq, val = pair.partition("=")
        if not eq:
            raise ValueError(f"fault option {pair!r} is not 'key=value'")
        if key == "uid":
            kw["uid"] = int(val)
        elif key == "replica":
            kw["replica"] = int(val)
        elif key == "s":
            kw["seconds"] = float(val)
        else:
            raise ValueError(f"unknown fault option {key!r} in {item!r}")
    return FaultEvent(kind=kind.strip(), step=int(step), **kw)


class FaultPlan:
    """An ordered, immutable schedule of :class:`FaultEvent`s."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(events,
                                               key=lambda e: (e.step, e.kind))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        items = [s.strip() for s in spec.split(";") if s.strip()]
        return cls(_parse_event(s) for s in items)

    @property
    def spec(self) -> str:
        return ";".join(e.spec for e in self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FaultPlan({self.spec!r})"


class FaultInjector:
    """Consumes a :class:`FaultPlan` against a live engine/fleet.

    Each hook is called from a fixed spot in the serving loop with the
    current step number; pending events whose step has arrived fire
    (once) and move to :attr:`fired`.
    """

    def __init__(self, plan: Union[FaultPlan, str, None] = None):
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        self.plan = plan or FaultPlan()
        self._pending: List[FaultEvent] = list(self.plan.events)
        self.fired: List[FaultEvent] = []

    def _take(self, kind: str, step: int, pred=None) -> List[FaultEvent]:
        hit = [e for e in self._pending
               if e.kind == kind and e.step <= step
               and (pred is None or pred(e))]
        for e in hit:
            self._pending.remove(e)
            self.fired.append(e)
        return hit

    # ------------------------------------------------------------ hooks
    def sleep(self, step: int) -> None:
        """Top of ``Engine.step``: straggler injection."""
        for e in self._take("slow", step):
            time.sleep(e.seconds)

    def step_error(self, step: int) -> None:
        """Inside the decode call bracket: hard step failure."""
        hit = self._take("error", step)
        if hit:
            raise InjectedFault(
                f"injected step failure (scheduled step {hit[0].step})")

    def pool_exhausted(self, step: int) -> bool:
        """``Engine._reserve``: force one PoolExhausted admission failure."""
        return bool(self._take("exhaust", step))

    def nan_uids(self, step: int, live_uids: Set[int]) -> List[int]:
        """Uids whose logits this step must poison (only fires for
        requests that are actually active, so the tripwire is hit)."""
        hit = self._take("nan", step, pred=lambda e: e.uid in live_uids)
        return [e.uid for e in hit]

    def kills(self, step: int) -> List[int]:
        """``ReplicaSet.step``: replica indices to kill this step."""
        return [e.replica for e in self._take("kill", step)]

    # ------------------------------------------------------------ intro
    @property
    def pending(self) -> Sequence[FaultEvent]:
        return tuple(self._pending)

    def summary(self) -> dict:
        return {
            "plan": self.plan.spec,
            "fired": [e.spec for e in self.fired],
            "pending": [e.spec for e in self._pending],
        }


def coerce_injector(
    faults: Union[FaultInjector, FaultPlan, str, None],
    *,
    env: bool = True,
) -> Optional[FaultInjector]:
    """Normalize a ``faults=`` argument to a shared injector (or None).

    ``None`` falls back to ``REPRO_FAULT_PLAN`` when ``env`` is set — the
    zero-code path to chaos-test any serving entry point.
    """
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, (FaultPlan, str)):
        return FaultInjector(faults) if faults else None
    if faults is None and env:
        spec = os.environ.get(FAULT_ENV, "").strip()
        if spec:
            return FaultInjector(spec)
    return None
