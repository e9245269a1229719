"""Logical-axis sharding rules (MaxText-style), as specs only.

PyTorch counterpart of ``repro.distribution.sharding``. Params and
activations are annotated with *logical* axis names; a rule set maps
logical names to physical mesh axes. ``spec_for`` resolves one tensor's
logical axes to a ``PartitionSpec`` on a ``Mesh``, with the reference's
semantics: a mesh axis shards at most one dim (the first use wins), a
dim that the axis size does not divide stays unsharded, and a rule onto
an axis the mesh lacks gives ``None``. ``zero1_spec`` adds ``data`` to an
optimizer state's largest free dim.

A ``Mesh`` here is an ordered axis shape (``launch.mesh`` builds them).
One bound to ranks also carries this rank's coordinates and a process
group per axis, and then a spec maps onto this rank: ``local_slice``
cuts its shard out of a full tensor, ``gather_axis`` concatenates an
axis group's shards of one dim (all-gather, or one broadcast per rank
for CUDA tensors on gloo: ``gather_route``), ``reshard`` gathers the
axes one spec names beyond another, and ``all_reduce_axes`` sums over
axis groups. A dim split over several axes, e.g. ``("pod", "data")``,
is split major to minor, as in JAX. ``shard_activation`` returns its
input, because the port's SPMD ranks slice and gather explicitly
(``distribution.tp``, ``training.train_loop``) instead of asking a
compiler to reshard.

The collectives record what they send. Inside ``recording(log)`` each
gather, broadcast and all-reduce calls ``log.add(kind, operand_bytes,
output_bytes)`` under the kind names of the reference's HLO cost model
(``all-gather``, ``collective-broadcast``, ``all-reduce``) with its
operand-bytes convention; on real ranks they also run (count mode). A
*traced* mesh (``launch.mesh.traced_mesh``) is bound to one chosen
rank's coordinates with no process groups: there they only record and
return a tensor of the right shape, which is how the dry run
(``python -m repro_torch.launch.dryrun``) follows one rank's step under
``FakeTensorMode``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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

    def __reduce__(self):
        # pickled as its parts (it travels between ranks)
        return (PartitionSpec, tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device axes in order, e.g. ``(("data", 16), ("model", 16))``.

    ``shape`` maps each axis to its size, in axis order. An abstract mesh
    (``launch.mesh.make_production_mesh``) is bound to no ranks. A mesh
    bound to ranks also carries this rank's ``coords`` and, for each
    axis it made a process group for, that group (``groups``) and its
    global ranks in axis order (``group_ranks``): a serving mesh has the
    ``model`` axis's, a training mesh every axis's. A traced mesh has
    ``coords`` and no groups (``traced``).
    """

    axes: Tuple[Tuple[str, int], ...]
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[str, Any]] = None
    group_ranks: Optional[Dict[str, Tuple[int, ...]]] = None
    #: bound to ``coords`` but to no process: collectives only record
    traced: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def model_group(self):
        return (self.groups or {}).get("model")

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        return (self.group_ranks or {}).get("model", ())

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.axes)}{', traced' if self.traced else ''})"


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
    logs: Tuple = ()


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


# ------------------------------------------------- specs onto this rank
#: the two routes of a gather over an axis group
GATHER_ROUTES = ("all_gather", "broadcast")


def _dist():
    import torch.distributed as dist
    return dist


def _names(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _parts(spec: Sequence, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def require_ranks(mesh: Mesh) -> Dict[str, int]:
    """This rank's coordinates on ``mesh`` (bound to ranks, or traced);
    an abstract mesh raises."""
    if mesh.coords is None:
        raise NotImplementedError(
            f"{mesh!r} is abstract (bound to no ranks): a step on the "
            "production meshes is traced per shard, not run: python -m "
            "repro_torch.launch.dryrun")
    return mesh.coords


@contextlib.contextmanager
def recording(log):
    """Record every collective called in this thread into ``log`` (an
    object with ``add(kind, operand_bytes, output_bytes)``) while the
    block runs; recordings nest."""
    prev = _CTX.logs
    _CTX.logs = prev + (log,)
    try:
        yield log
    finally:
        _CTX.logs = prev


class CollectiveLog:
    """Operand bytes by kind (``recording``'s plain log)."""

    def __init__(self):
        self.by_kind: Dict[str, int] = {}

    def add(self, kind: str, operand_bytes: int, output_bytes: int) -> None:
        self.by_kind[kind] = self.by_kind.get(kind, 0) + int(operand_bytes)


def _record(kind: str, operand, output) -> None:
    for log in _CTX.logs:
        log.add(kind, operand.numel() * operand.element_size(),
                output.numel() * output.element_size())


def map_specs(fn, tree, *specs):
    """``fn(leaf, spec, ...)`` over the leaves of a dict tree, each with
    the matching entry of every tree in ``specs`` (trees of logical axes
    or PartitionSpecs, whose tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(s[k] for s in specs))
                for k, v in tree.items()}
    return fn(tree, *specs)


def shard_index(mesh: Mesh, names: Sequence[str]) -> Tuple[int, int]:
    """(this rank's shard index, shard count) of a dim split over
    ``names``, major to minor."""
    coords, sizes = require_ranks(mesh), mesh.shape
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_shape(shape: Sequence[int], spec: Sequence,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one shard of a ``shape`` tensor laid out by ``spec``."""
    sizes = mesh.shape
    out = []
    for dim, part in zip(shape, _parts(spec, len(shape))):
        n = 1
        for a in _names(part):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def local_slice(x, spec: Sequence, mesh: Mesh):
    """This rank's shard of the full tensor ``x`` laid out by ``spec`` (a
    view)."""
    for d, part in enumerate(_parts(spec, x.ndim)):
        names = _names(part)
        if names:
            i, n = shard_index(mesh, names)
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x


def gather_route(group, device) -> str:
    """The route of a gather over ``group`` for tensors on ``device``:
    gloo gathers only CPU tensors, so CUDA tensors on a gloo group go by
    broadcasts."""
    import torch
    backend = str(_dist().get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "broadcast"
    return "all_gather"


def _all_gather(out, inp, group):
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def gather_axis(x, dim: int, mesh: Mesh, axis: str,
                route: Optional[str] = None):
    """Exact concatenation along ``dim`` of the shards that the ranks of
    this rank's ``axis`` group hold, in axis order: the same tensor on
    every rank of the group, contiguous. ``route`` forces one of
    ``GATHER_ROUTES`` (default: ``gather_route``; ``all_gather`` on a
    traced mesh)."""
    import torch
    n = int(mesh.shape.get(axis, 1))
    if n == 1:
        return x
    if mesh.traced:
        group = ranks = None
        route = route or "all_gather"   # what NCCL ranks of their own take
    else:
        group, ranks = mesh.groups[axis], mesh.group_ranks[axis]
        route = route or gather_route(group, x.device)
    if route not in GATHER_ROUTES:
        raise ValueError(f"route must be one of {GATHER_ROUTES}, got "
                         f"{route!r}")
    xc = x.movedim(dim, 0).contiguous()
    if route == "all_gather":
        # the concatenated output form (gloo takes no other)
        full = torch.empty((n * xc.shape[0],) + tuple(xc.shape[1:]),
                           dtype=xc.dtype, device=xc.device)
        _record("all-gather", xc, full)
        if not mesh.traced:
            _all_gather(full, xc, group)
    else:
        me = require_ranks(mesh)[axis]
        parts = []
        for i in range(n):
            part = xc if i == me else torch.empty_like(xc)
            _record("collective-broadcast", part, part)
            if not mesh.traced:
                _dist().broadcast(part, src=ranks[i], group=group)
            parts.append(part)
        full = torch.cat(parts)
    # in the full tensor's own layout: a strided view would send a matmul
    # down another kernel, whose sums round apart from the unsharded step's
    return full.movedim(0, dim).contiguous()


def reshard(x, src: Sequence, dst: Sequence, mesh: Mesh):
    """This rank's shard under ``dst`` from its shard under ``src``, where
    each dim of ``dst`` names a leading part of ``src``'s axes for that
    dim: the axes ``src`` names beyond it are gathered, minor first, so
    that the pieces land major to minor."""
    ps, pd = _parts(src, x.ndim), _parts(dst, x.ndim)
    for d in range(x.ndim):
        have, want = _names(ps[d]), _names(pd[d])
        if have[:len(want)] != want:
            raise ValueError(f"dim {d}: cannot reshard {ps[d]!r} to "
                             f"{pd[d]!r} by gathers")
        for a in reversed(have[len(want):]):
            x = gather_axis(x, d, mesh, a)
    return x


def gather_full(x, spec: Sequence, mesh: Mesh):
    """The full tensor from this rank's shard under ``spec``."""
    return reshard(x, spec, (), mesh)


def all_reduce_axes(x, mesh: Mesh, axes: Sequence[str], op: str = "sum"):
    """``x`` reduced in place (``op`` "sum" or "max") over this rank's
    group of each of ``axes`` (an axis the mesh lacks, or of size 1, is
    skipped); returns ``x``. On a traced mesh ``x`` is returned as it is
    (only recorded)."""
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            _record("all-reduce", x, x)
            if not mesh.traced:
                dist = _dist()
                red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
                dist.all_reduce(x, op=red[op], group=mesh.groups[a])
    return x

