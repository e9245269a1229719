"""Loops of identical iterations, which a cost tracer may collapse.

The microbatches of a train step and the steps of a recurrent scan run
the same ops on every iteration. Code that runs such a loop iterates
``trips(m)`` (``trips(m, carry=True)`` where an iteration passes a state
on) and joins the iterations' outputs with ``gathered``. Outside a
``collapsing`` block that is ``range(m)`` and ``torch.stack``/``cat``,
the plain loop. Inside one, the installed hook decides which iterations
run (``roofline.trace_cost.TraceCost`` runs one, or four of a scan, and
counts each for the iterations it stands for). This module holds only
that thread-local hook, so the models and the train loop depend on no
measurement tool.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Iterable, List

import torch

_LOCAL = threading.local()


@contextmanager
def collapsing(hook: Callable[[int, bool], Iterable[int]]):
    """Make ``hook(m, carry)`` yield the iterations of every ``trips``
    loop of more than one iteration (more than four with ``carry``) run
    by the calling thread inside the block."""
    prev = getattr(_LOCAL, "hook", None)
    _LOCAL.hook = hook
    try:
        yield
    finally:
        _LOCAL.hook = prev


def trips(m: int, carry: bool = False) -> Iterable[int]:
    """The iterations of a loop of ``m`` identical iterations:
    ``range(m)``, or what the ``collapsing`` hook yields."""
    hook = getattr(_LOCAL, "hook", None)
    if hook is None or m <= 1 or (carry and m <= 4):
        return range(m)
    return hook(m, carry)


def gathered(ys: List[torch.Tensor], n: int, dim: int,
             cat: bool = False) -> torch.Tensor:
    """``torch.stack`` (``cat``: ``torch.cat``) along ``dim`` of the
    outputs of a ``trips(n)`` loop's iterations; where a hook collapsed
    the loop, the output of the iteration that stands for several is
    repeated for each of them (an expanded view)."""
    if len(ys) == n:
        return torch.cat(ys, dim) if cat else torch.stack(ys, dim)
    rep = 1 if len(ys) > 1 else 0
    parts = [t.unsqueeze(dim) for t in ys]
    shape = list(parts[rep].shape)
    shape[dim] = n - len(ys) + 1
    parts[rep] = parts[rep].expand(shape)
    y = torch.cat(parts, dim)
    return y.flatten(dim, dim + 1) if cat else y
