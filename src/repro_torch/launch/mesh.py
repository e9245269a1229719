"""Meshes over ``torch.distributed`` ranks.

PyTorch counterpart of ``repro.launch.mesh``:

* ``make_production_mesh`` — the production shapes, (data=16, model=16)
  or (pod=2, data=16, model=16), as an *abstract* mesh bound to no ranks
  (a planner lowers a cell per shard on it; nothing runs on 256 ranks);
* ``make_serving_mesh(tp, dp)`` — (data=dp, model=tp) over the ranks of
  the initialized default process group, which plays the part of the
  reference's "devices present": rank r is data index r // tp and model
  index r % tp, and the mesh carries the process group of r's ``model``
  axis (``dist.new_group``, made by every rank for every subgroup in the
  same order, with a timeout);
* ``make_host_mesh(model)`` — the same over the whole world.
"""
from __future__ import annotations

import datetime

from repro_torch.distribution.sharding import Mesh

#: timeout of every process group this module makes: a rank that parts
#: from the others fails its next collective instead of hanging
GROUP_TIMEOUT_S = 60.0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(tuple(zip(axes, shape)))


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def make_serving_mesh(tp: int = 1, dp: int = 1) -> Mesh:
    """Small serving mesh: (data=dp, model=tp) over the ranks of the
    default process group. ``tp`` shards KV-head/pool state, ``dp`` is
    the engine-replica axis. A world of k * tp * dp ranks holds k copies
    of the mesh, each over tp * dp consecutive ranks, which serve alike;
    a rank past the last whole copy raises. Every rank of the world must
    call it, in the same order as its other collectives: the ``model``
    subgroups are made here."""
    tp, dp = int(tp), int(dp)
    if tp < 1 or dp < 1:
        raise ValueError(f"make_serving_mesh: tp={tp} dp={dp} must be >= 1")
    need = tp * dp
    have = world_size()
    if have < need:
        raise RuntimeError(
            f"serving mesh (dp={dp}, tp={tp}) needs {need} ranks, have "
            f"{have} — launch with torchrun --nproc-per-node {need}")
    axes = (("data", dp), ("model", tp))
    if have == 1:
        return Mesh(axes, coords={"data": 0, "model": 0},
                    model_ranks=(0,))
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    rank = dist.get_rank()
    mine = None
    for first in range(0, have - have % need, tp):
        ranks = tuple(range(first, first + tp))
        group = dist.new_group(list(ranks), timeout=timeout)
        if rank in ranks:
            mine = (group, ranks)
    if mine is None:
        raise RuntimeError(
            f"rank {rank} lies outside the serving meshes (dp={dp}, "
            f"tp={tp}) of ranks 0..{have - have % need - 1}")
    group, ranks = mine
    return Mesh(axes, coords={"data": rank % need // tp, "model": rank % tp},
                model_group=group, model_ranks=ranks)


def make_host_mesh(model: int = 1) -> Mesh:
    """Small serving mesh over the whole world (tests, examples)."""
    n = world_size()
    model = max(1, min(model, n))
    return make_serving_mesh(tp=model, dp=n // model)
