"""Tensor-parallel serving: head-sharded paged HDP attention, SPMD.

PyTorch counterpart of ``repro.distribution.tp``. HDP prunes per head —
the scout's block keep mask and the early head gate (``theta_head >
tau_h``, an absolute threshold with no cross-head reduction, see
``core.hdp.decode_scout``) are computed independently per KV head. That
makes the head axis the natural shard dimension for serving.

Every rank of a serving mesh's ``model`` axis runs the same engine on
the same requests (weights, prefill and the dense layers replicated),
and holds 1/TP of the paged pool's KV heads (int8 codes, scales and
scout views). It runs the scout, the keep mask and stage 3 on its own
heads only: a shard's fetched set is the OR of *its* heads' keep masks,
and masked softmax zeroes non-kept pages exactly, so per-head outputs
are bitwise those of the unsharded engine at any TP degree.

The only cross-rank traffic of a decode layer is one exact gather of the
per-head attention output before the output projection: a concatenation,
no float reduction, so the tokens are byte-identical to TP 1. Sparsity
stats are shard-local and averaged over the model axis; ``theta_head``
is gathered back to full width. The gather takes one of two routes, by
the group's backend: ``all_gather_single`` (``all_gather_into_tensor``
before it) where the backend gathers the tensor's device (NCCL, and
gloo on the CPU), or one ``broadcast`` per rank into its slice, which is
what gloo offers for CUDA tensors (its GPU collectives are broadcast,
all_reduce and barrier).

The mesh is ambient context (thread-local, as in the reference): the
engine wraps its steps in :func:`serving_mesh`, and the model layer
consults :func:`active_serving_mesh` to route paged-decode calls through
:func:`tp_paged_attention`. A decision that reads a clock or a measured
time (deadlines, the scheduler's watchdog, the tuner's probes) is taken
on the group's first rank and broadcast (:func:`agreed_floats`): a rank
that parted from the others would meet them at different collectives.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from repro_torch.distribution.sharding import Mesh, PartitionSpec

_ctx = threading.local()

#: head (sharded) axis index of each pool leaf in the FULL pool
#: [L, P, ps, N, hd] / scales [L, P, N]; per-layer views drop the
#: leading L. Scout views mirror the page layout.
POOL_HEAD_AXIS = {
    "k_pages": 3, "v_pages": 3, "k_scout": 3, "f_scout": 3,
    "k_scale": 2, "v_scale": 2,
}

#: the two routes of the head gather
GATHER_ROUTES = ("all_gather", "broadcast")


class HeadShard(NamedTuple):
    """The heads of a pool leaf this rank holds: ``axis`` and the global
    head range ``[start, stop)``."""
    axis: int
    start: int
    stop: int


@contextmanager
def serving_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the ambient serving mesh for the calling thread."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def active_serving_mesh() -> Optional[Mesh]:
    return getattr(_ctx, "mesh", None)


def mesh_tp(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def active_tp() -> int:
    """TP degree of the ambient serving mesh (1 when unsharded)."""
    return mesh_tp(active_serving_mesh())


def pool_pspec(name: str, *, per_layer: bool = False) -> PartitionSpec:
    """PartitionSpec sharding pool leaf ``name`` on the model axis."""
    ax = POOL_HEAD_AXIS.get(name)
    if ax is None:
        return PartitionSpec()
    if per_layer:
        ax -= 1
    return PartitionSpec(*([None] * ax + ["model"]))


def pool_shardings(mesh: Mesh, pool: Dict[str, Sequence[int]], *,
                   per_layer: bool = False) -> Dict[str, HeadShard]:
    """The head range of each pool leaf this rank holds, from the leaves'
    FULL shapes (``pool`` maps a name to a shape or a tensor): heads
    ``[m * N/tp, (m + 1) * N/tp)`` for model index m."""
    tp, m = mesh_tp(mesh), (mesh.coords or {}).get("model", 0)
    out = {}
    for name, leaf in pool.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        ax = POOL_HEAD_AXIS[name] - (1 if per_layer else 0)
        n = shape[ax]
        if n % tp:
            raise ValueError(f"{name}: {n} heads not divisible by tp={tp}")
        out[name] = HeadShard(ax, m * n // tp, (m + 1) * n // tp)
    return out


def constrain_pool(pool: dict, mesh: Optional[Mesh], *,
                   per_layer: bool = False) -> dict:
    """The reference re-asserts the pool's shardings inside a jit body;
    the port's pool leaves already hold this rank's heads, so this checks
    that they agree on the local head count and returns ``pool``."""
    if mesh is None:
        return pool
    counts = {leaf.shape[POOL_HEAD_AXIS[name] - (1 if per_layer else 0)]
              for name, leaf in pool.items()}
    if len(counts) > 1:
        raise ValueError(f"pool leaves hold different head counts {counts}")
    return pool


def replicated(x, mesh: Optional[Mesh]):
    """Every rank computes replicated values itself: ``x`` unchanged."""
    return x


def local_heads(x: torch.Tensor, dim: int, mesh: Optional[Mesh]):
    """This rank's slice of the head axis ``dim`` of a replicated tensor
    (a view)."""
    tp = mesh_tp(mesh)
    if tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"{n} heads not divisible by tp={tp}")
    m = mesh.coords["model"]
    return x.narrow(dim, m * n // tp, n // tp)


def _dist():
    import torch.distributed as dist
    return dist


def gather_route(mesh: Mesh, device) -> str:
    """The head gather's route on the mesh's model group for tensors on
    ``device``: gloo gathers only CPU tensors, so CUDA tensors on a gloo
    group go by broadcasts."""
    backend = str(_dist().get_backend(mesh.model_group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "broadcast"
    return "all_gather"


def _all_gather(out, inp, group):
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def gather_heads(x: torch.Tensor, dim: int, mesh: Mesh,
                 route: Optional[str] = None) -> torch.Tensor:
    """Exact concatenation over the model group of every rank's slice of
    axis ``dim`` (model order): the full-width tensor on every rank.
    ``route`` forces one of ``GATHER_ROUTES`` (default: ``gather_route``)."""
    tp = mesh_tp(mesh)
    if tp == 1:
        return x
    route = route or gather_route(mesh, x.device)
    if route not in GATHER_ROUTES:
        raise ValueError(f"route must be one of {GATHER_ROUTES}, got "
                         f"{route!r}")
    xc = x.movedim(dim, 0).contiguous()
    if route == "all_gather":
        # the concatenated output form (gloo takes no other)
        full = torch.empty((tp * xc.shape[0],) + tuple(xc.shape[1:]),
                           dtype=xc.dtype, device=xc.device)
        _all_gather(full, xc, mesh.model_group)
    else:
        dist, me = _dist(), mesh.coords["model"]
        parts = []
        for i, src in enumerate(mesh.model_ranks):
            part = xc if i == me else torch.empty_like(xc)
            dist.broadcast(part, src=src, group=mesh.model_group)
            parts.append(part)
        full = torch.cat(parts)
    return full.movedim(0, dim)


def agreed_floats(values: Sequence[float],
                  mesh: Optional[Mesh] = None) -> list:
    """``values`` as the model group's first rank holds them, on every
    rank (a host decision taken once and broadcast); unchanged without a
    mesh (default: the ambient one) or at TP 1."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if mesh_tp(mesh) == 1:
        return list(values)
    dist = _dist()
    dev = "cuda" if "nccl" in str(dist.get_backend(mesh.model_group)) \
        else "cpu"
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.broadcast(t, src=mesh.model_ranks[0], group=mesh.model_group)
    return t.tolist()


def _combine_stats(stats, mesh: Mesh):
    """Per-shard AttnStats -> the reference's combination: block, head and
    page sparsity averaged over the model axis, ``theta_head`` gathered
    on axis 1. One gather of all of them packed into an fp32 vector."""
    from repro_torch.attention.stats import AttnStats

    names = ("block_sparsity", "head_sparsity", "page_sparsity",
             "theta_head")
    leaves = {n: getattr(stats, n) for n in names
              if getattr(stats, n) is not None}
    flat = torch.cat([leaves[n].reshape(-1).to(torch.float32)
                      for n in leaves])
    g = gather_heads(flat[None], 0, mesh)         # [tp, total]
    tp, out, off = mesh_tp(mesh), {}, 0
    for n, leaf in leaves.items():
        k = leaf.numel()
        part = g[:, off:off + k].reshape((tp,) + tuple(leaf.shape))
        off += k
        if n == "theta_head":
            out[n] = torch.cat(part.unbind(0), dim=1).to(leaf.dtype)
        else:
            out[n] = (part.sum(0) / tp).to(leaf.dtype)
    return AttnStats(block_sparsity=out["block_sparsity"],
                     head_sparsity=out["head_sparsity"],
                     theta_head=out.get("theta_head"),
                     page_sparsity=out.get("page_sparsity"))


def tp_paged_attention(q, call, spec, *, q_pos, k_pos, cache, page_table,
                       mesh: Mesh):
    """Head-sharded paged-decode attention under ``mesh``.

    ``q`` [B,N,G,Sq,hd] with N the full KV-head axis; ``cache`` is this
    rank's per-layer pool view (pages [P,ps,N/tp,hd], scales [P,N/tp]).
    The registry dispatch runs on the local head slice of ``q`` — the
    scout, keep mask, page fetch list and stage-3 kernel all see N/tp
    heads and a per-shard fetched set. Returns the full-width ``(out,
    stats)``: ``out`` gathered over heads by exact concatenation.
    """
    from repro_torch.attention.registry import attention

    tp = mesh_tp(mesh)
    n_kv = q.shape[1]
    if tp == 1 or n_kv % tp != 0:
        return attention(q, None, None, call, spec=spec, q_pos=q_pos,
                         k_pos=k_pos, cache=cache, page_table=page_table)
    out, stats = attention(local_heads(q, 1, mesh).contiguous(), None,
                           None, call,
                           spec=spec, q_pos=q_pos, k_pos=k_pos, cache=cache,
                           page_table=page_table)
    out = gather_heads(out, 1, mesh)
    if stats is not None:
        stats = _combine_stats(stats, mesh)
    return out, stats
