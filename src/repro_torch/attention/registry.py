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
* Under the cost policy (``AttnSpec(policy="cost")``, or policy "auto"
  with ``REPRO_ATTN_POLICY=cost``) an "auto" request is ranked by the
  ``repro_torch.autotune`` tuner on the call's shape signature
  (``REPRO_ATTN_BACKEND`` still wins over it). The reference consults
  the tuner once per jit trace; the port on every eager dispatch, and on
  the warm-up and the capture of a CUDA graph.
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

#: env var deciding how policy="auto" specs rank auto-selected backends:
#: "cost" routes through the repro_torch.autotune cost model; anything
#: else (including unset) keeps the static priority order.
POLICY_ENV = "REPRO_ATTN_POLICY"

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


def effective_policy(spec: AttnSpec) -> str:
    """The selection policy ``spec`` actually runs under: its own unless
    "auto", in which case REPRO_ATTN_POLICY=cost opts the process in."""
    if spec.policy != "auto":
        return spec.policy
    return ("cost" if os.environ.get(POLICY_ENV, "").strip() == "cost"
            else "static")


_COST_WARNED = False


def resolve_backend(call: AttnCall, spec: Optional[AttnSpec] = None, *,
                    sig=None, tuner=None) -> Backend:
    """Pick the backend serving ``call`` under ``spec``.

    ``sig`` (a :class:`repro_torch.autotune.cost.CallSig`) activates
    cost-based ranking of the auto candidates when the spec's effective
    policy is "cost"; without it (or under explicit requests) the static
    priority order decides. ``tuner`` overrides the process-default
    tuner.
    """
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
    if req == "auto" and sig is not None and effective_policy(spec) == "cost":
        try:
            if tuner is None:
                from repro_torch.autotune.tuner import default_tuner
                tuner = default_tuner()
            return tuner.choose(call, sig, cands)
        except Exception:
            # never let a cost-model bug change dispatch correctness —
            # degrade to the static order, warn once per process
            global _COST_WARNED
            if not _COST_WARNED:
                _COST_WARNED = True
                import warnings
                warnings.warn("cost-policy backend selection failed; "
                              "falling back to static priority order",
                              RuntimeWarning, stacklevel=2)
            return best(cands)
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
    sig = None
    eff_spec = spec if spec is not None else default_spec()
    if (effective_policy(eff_spec) == "cost"
            and eff_spec.requested_for(call.mode) == "auto"):
        # the signature reads shapes and dtypes only, so consulting the
        # tuner reads nothing back from the device (a graph capture can
        # hold the call); tp is 1 until the port serves tensor-parallel
        from repro_torch.autotune.cost import call_signature
        sig = call_signature(call, q, k=k, cache=cache,
                             page_table=page_table, tp=1)
    backend = resolve_backend(call, eff_spec, sig=sig)
    return backend.run(q, k, v, call, q_pos=q_pos, k_pos=k_pos,
                       cache=cache, page_table=page_table)
