"""Attention-backend registry: declare capabilities, dispatch one entry.

PyTorch counterpart of ``repro.attention.registry``. Each backend
registers a ``run`` callable, a ``supports(call)`` predicate and a
priority; :func:`attention` is the single dispatch entry the model layer
calls.

* ``AttnSpec(backend="auto")`` picks the highest-priority backend whose
  ``supports(call)`` is True. Each backend's priority is the reference's
  *TPU* rank (its ``tpu_priority``), on every device: each hand-kernel
  backend has its plain PyTorch version for CPU tensors, so the CPU runs
  the same dispatch as the card, and the kernels rank above the plain
  PyTorch paths; ``reference`` ranks last.
* An exact name or a family tag requests that implementation; if it
  cannot serve the call the spec falls down the auto chain
  (``allow_fallback=True``) or raises ``BackendUnsupported``.
* ``REPRO_ATTN_BACKEND`` overrides every "auto" request; explicit
  non-auto requests win over it.
* The cost policy is not ported yet: ``AttnSpec(policy="cost")`` raises
  ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.attention.spec import AttnCall, AttnSpec

#: env var forcing every "auto" backend request (explicit requests win).
BACKEND_ENV = "REPRO_ATTN_BACKEND"

_BACKEND_MODULES = ("repro_torch.attention.reference",
                    "repro_torch.attention.backends")


class BackendUnsupported(ValueError):
    """Requested backend cannot serve the call and fallback is disabled."""


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered attention implementation.

    ``run(q, k, v, call, *, q_pos, k_pos, cache, page_table)`` returns
    ``(out, AttnStats | None)``; the highest ``priority`` wins among
    the backends that support a call."""

    name: str
    run: Callable
    supports: Callable[[AttnCall], bool]
    priority: int
    tags: frozenset


_REGISTRY: Dict[str, Backend] = {}
_LOADED = False


def register_backend(name: str, *, supports: Callable[[AttnCall], bool],
                     priority: int, tags=()):
    """Decorator registering ``fn`` as backend ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = Backend(
            name=name, run=fn, supports=supports, priority=priority,
            tags=frozenset(tags))
        return fn

    return deco


def _ensure_backends() -> None:
    """Import the backend modules lazily (they import the model layer,
    which imports this package: top-level imports would cycle)."""
    global _LOADED
    if not _LOADED:
        _LOADED = True
        for mod in _BACKEND_MODULES:
            importlib.import_module(mod)


def list_backends() -> List[Backend]:
    _ensure_backends()
    return sorted(_REGISTRY.values(), key=lambda b: (-b.priority, b.name))


def get_backend(name: str) -> Backend:
    _ensure_backends()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown attention backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def known_backend_names() -> List[str]:
    """Every resolvable request: backend names, family tags, "auto"."""
    _ensure_backends()
    names = {n for b in _REGISTRY.values() for n in (b.name, *b.tags)}
    return sorted(names | {"auto"})


def default_spec() -> AttnSpec:
    """The spec used when none is threaded (honors REPRO_ATTN_BACKEND)."""
    return AttnSpec(backend=os.environ.get(BACKEND_ENV, "auto"))


def resolve_backend(call: AttnCall,
                    spec: Optional[AttnSpec] = None) -> Backend:
    """Pick the backend serving ``call`` under ``spec``."""
    _ensure_backends()
    spec = spec if spec is not None else default_spec()
    cands = [b for b in _REGISTRY.values() if b.supports(call)]
    if not cands:
        raise BackendUnsupported(f"no registered backend supports {call}")

    def best(pool):
        return max(pool, key=lambda b: (b.priority, b.name))

    req = spec.requested_for(call.mode)
    if req == "auto":
        # "auto" always consults the env override; explicit non-auto
        # requests still win
        req = os.environ.get(BACKEND_ENV, "auto")
    if req != "auto":
        known = {n for b in _REGISTRY.values() for n in (b.name, *b.tags)}
        if req not in known:
            raise KeyError(
                f"unknown attention backend {req!r}; registered: "
                f"{sorted(known)}")
        exact = _REGISTRY.get(req)
        if exact is not None and exact in cands:
            return exact
        tagged = [b for b in cands if req in b.tags]
        if tagged:
            return best(tagged)
        if not spec.allow_fallback:
            raise BackendUnsupported(
                f"backend {req!r} does not support {call} "
                "(allow_fallback=False)")
    return best(cands)


def attention(q, k, v, call: AttnCall, *, spec: Optional[AttnSpec] = None,
              q_pos=None, k_pos=None, cache=None, page_table=None):
    """Single dispatch entry: resolve a backend and run the call.

    q [B,N,G,Sq,hd]; k/v [B,Sk,N,hd] (dense layout; None for paged calls,
    whose K/V live in ``cache`` pools indexed by ``page_table``).
    ``q_pos``/``k_pos`` are broadcastable position arrays (-1 = invalid),
    ``arange`` when omitted. Returns ``(out [B,N,G,Sq,hd], AttnStats |
    None)``."""
    if q_pos is None:
        q_pos = torch.arange(q.shape[-2], device=q.device)
    if k_pos is None and k is not None:
        k_pos = torch.arange(k.shape[1], device=q.device)
    backend = resolve_backend(call, spec)
    return backend.run(q, k, v, call, q_pos=q_pos, k_pos=k_pos,
                       cache=cache, page_table=page_table)
