"""Shared transient-error taxonomy for serving (and, later, training)
retries. PyTorch-port copy of ``repro.common.transient``, kept here so
that the port imports nothing of the JAX package.

A *transient* failure is one that is expected under load and safe to
retry or defer: pool pressure, collective timeouts, network hiccups,
preemption. Everything else (assertion failures, shape errors, injected
chaos faults) is a programming error and must fail fast instead of
burning retry budget masking the bug.

Raise :class:`TransientError` (or a subclass) to mark a failure as
retryable by construction. :func:`is_transient` classifies arbitrary
exceptions: typed ``TransientError``s and OS-level errors are transient;
bare ``RuntimeError``s are transient only when their message matches a
known-transient pattern (runtimes surface collective timeouts and
resource exhaustion as plain RuntimeErrors, so a message filter is the
only handle on them).
"""
from __future__ import annotations

#: substrings (lowercased) that mark a bare RuntimeError as transient
TRANSIENT_PATTERNS = (
    "timeout",
    "timed out",
    "unavailable",
    "connection",
    "collective",
    "resource exhausted",
    "resource_exhausted",
    "deadline exceeded",
    "deadline_exceeded",
    "preempted",
    "temporarily",
    "pool exhausted",
)


class TransientError(RuntimeError):
    """A failure expected under load and safe to retry or defer."""


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is safe to retry (typed transient, OS-level, or
    a bare RuntimeError whose message matches a known-transient shape)."""
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, (OSError, TimeoutError)):
        return True
    if type(exc) is RuntimeError:
        msg = str(exc).lower()
        return any(p in msg for p in TRANSIENT_PATTERNS)
    return False
