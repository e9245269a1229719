"""Logical-axis sharding rules (MaxText-style), as specs only.

PyTorch counterpart of ``repro.distribution.sharding``. Params and
activations are annotated with *logical* axis names; a rule set maps
logical names to physical mesh axes. ``spec_for`` resolves one tensor's
logical axes to a ``PartitionSpec`` on a ``Mesh``, with the reference's
semantics: a mesh axis shards at most one dim (the first use wins), a
dim that the axis size does not divide stays unsharded, and a rule onto
an axis the mesh lacks gives ``None``. ``zero1_spec`` adds ``data`` to an
optimizer state's largest free dim.

This module computes specs and allocates nothing: a ``Mesh`` here is an
ordered axis shape (``launch.mesh`` builds them, a serving mesh with the
process group of its ``model`` axis), and ``shard_activation`` returns
its input, because the port's SPMD serving slices and gathers explicitly
(``distribution.tp``) instead of asking a compiler to reshard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes (a name, a tuple of names, or None),
    ``jax.sharding.PartitionSpec``'s stand-in: ``P("model", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device axes in order, e.g. ``(("data", 16), ("model", 16))``.

    ``shape`` maps each axis to its size, in axis order. An abstract mesh
    (``launch.mesh.make_production_mesh``) is bound to no ranks; a
    serving mesh (``make_serving_mesh``) also carries this rank's
    coordinates, the process group of its ``model`` axis and the global
    ranks of that group in model order.
    """

    axes: Tuple[Tuple[str, int], ...]
    coords: Optional[Dict[str, int]] = None
    model_group: Any = None
    model_ranks: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.axes)})"


# -------------------------------------------------------------------- rules
# Tensor-parallel default: weights sharded on `model` only; optimizer states
# additionally ZeRO-1 sharded over `data` (``zero1_spec``).
RULES_TP: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "embed": None,
    "table_embed": None,   # vocab-table d_model dim: never FSDP over data
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "layers": None,
    "groups": None,
    "state": None,
    "conv": None,
    "kv_seq": None,
    # activation-only axes
    "heads_act": "model",
    "mlp_act": "model",
    "embed_act": None,
    "seq_act": None,
    "vocab_act": "model",
    "experts_act": "model",
}

# FSDP+TP: large weight matrices additionally sharded over `data` on their
# embed/replicated dimension (ZeRO-3-like).
RULES_FSDP_TP = dict(RULES_TP, embed=("pod", "data"))


class _Ctx(threading.local):
    mesh: Optional[Mesh] = None
    rules: Optional[Dict[str, Axis]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def logical_axis_rules(mesh: Mesh, rules: Dict[str, Axis]):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def _physical(axis: Axis, mesh: Mesh, rules: Dict[str, Axis]):
    if axis is None:
        return None
    name = rules.get(axis, None) if isinstance(axis, str) else axis
    if name is None:
        return None
    if isinstance(name, str):
        return name if name in mesh.axis_names else None
    present = tuple(a for a in name if a in mesh.axis_names)
    return present if present else None


def spec_for(logical: Sequence[Axis], shape: Sequence[int],
             mesh: Optional[Mesh] = None,
             rules: Optional[Dict[str, Axis]] = None) -> PartitionSpec:
    """Resolve logical axes -> PartitionSpec.

    Drops non-divisible shards, and deduplicates mesh axes across dims
    (a mesh axis may shard at most one dim; first occurrence wins — e.g.
    MoE ``(experts, mlp, embed)`` with both experts and mlp -> ``model``
    resolves to pure expert parallelism).
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return P()
    sizes = mesh.shape
    out = []
    used: set = set()
    for dim, ax in zip(shape, logical):
        phys = _physical(ax, mesh, rules)
        if phys is None:
            out.append(None)
            continue
        names = (phys,) if isinstance(phys, str) else tuple(phys)
        names = tuple(a for a in names if a not in used)
        if not names:
            out.append(None)
            continue
        size = 1
        for a in names:
            size *= sizes[a]
        if dim % size == 0:
            used.update(names)
            out.append(names[0] if len(names) == 1 else names)
        else:
            out.append(None)
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def tree_specs(params, logical_tree, mesh: Mesh, rules: Dict[str, Axis]):
    """Map a (params, logical-axes) tree pair to PartitionSpecs (the
    reference's NamedShardings, whose mesh is ``mesh``)."""
    if _is_axes(logical_tree):
        return spec_for(logical_tree, tuple(params.shape), mesh, rules)
    if isinstance(params, dict):
        return {k: tree_specs(v, logical_tree[k], mesh, rules)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_specs(v, a, mesh, rules)
                            for v, a in zip(params, logical_tree))
    raise TypeError(f"tree_specs: no logical axes for a "
                    f"{type(params).__name__} leaf")


def shard_activation(x, *logical: Axis):
    """The reference's sharding constraint by logical axes. The port's
    SPMD ranks slice and gather explicitly, so this returns ``x`` itself,
    inside a rules context as outside one."""
    return x


def zero1_spec(logical: Sequence[Axis], shape: Sequence[int],
               mesh: Mesh, rules: Dict[str, Axis]) -> PartitionSpec:
    """Optimizer-state spec: like the weight but with `data` added on the
    largest still-unsharded divisible dim (ZeRO-1)."""
    base = spec_for(logical, shape, mesh, rules)
    parts = list(base) + [None] * (len(shape) - len(base))
    if any(p is not None and "data" in (p if isinstance(p, tuple) else (p,))
           for p in parts):
        return base
    sizes = mesh.shape
    dsz = sizes.get("data", 1)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if parts[i] is None and shape[i] % dsz == 0 and shape[i] >= dsz:
            parts[i] = "data"
            return P(*parts)
        if parts[i] is not None:
            phys = parts[i] if isinstance(parts[i], tuple) else (parts[i],)
            if "data" not in phys and "model" in phys:
                sz = dsz * sizes["model"]
                if shape[i] % sz == 0:
                    parts[i] = tuple(phys) + ("data",)
                    return P(*parts)
    return base
