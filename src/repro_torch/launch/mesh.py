"""Meshes over ``torch.distributed`` ranks.

PyTorch counterpart of ``repro.launch.mesh``:

* ``make_production_mesh`` — the production shapes, (data=16, model=16)
  or (pod=2, data=16, model=16), as an *abstract* mesh bound to no ranks
  (nothing runs on 256 ranks);
* ``traced_mesh(mesh, rank)`` — the same axes bound to one rank's
  coordinates with no process groups: the dry run traces that rank's
  step on it (``launch.dryrun``);
* ``make_serving_mesh(tp, dp)`` — (data=dp, model=tp) over the ranks of
  the initialized default process group, which plays the part of the
  reference's "devices present": rank r is data index r // tp and model
  index r % tp, and the mesh carries the process group of r's ``model``
  axis (``dist.new_group``, made by every rank for every subgroup in the
  same order, with a timeout);
* ``make_host_mesh(model)`` — the same over the whole world;
* ``make_training_mesh(model)`` — (data, model) over the whole world,
  with this rank's coordinates and a process group for each axis (the
  train step gathers params over ``model`` and ``data`` and reduces
  gradients over ``data``);
* ``init_world(device)`` — join the process group of a ``torchrun``
  launch.
"""
from __future__ import annotations

import datetime
import os

from repro_torch.distribution.sharding import Mesh

#: timeout of every process group this module makes: a rank that parts
#: from the others fails its next collective instead of hanging
GROUP_TIMEOUT_S = 60.0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(tuple(zip(axes, shape)))


def traced_mesh(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh``'s axes bound to the coordinates of ``rank``, numbered
    row-major over the axes (the last axis fastest, as
    ``make_training_mesh`` numbers them), with no process groups: its
    collectives record and return shapes (``sharding.gather_axis``)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside {mesh!r} of {mesh.size}")
    coords, r = {}, rank
    for name, n in reversed(mesh.axes):
        coords[name], r = r % n, r // n
    return Mesh(mesh.axes, coords={a: coords[a] for a in mesh.axis_names},
                traced=True)


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
                    group_ranks={"model": (0,)})
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
                groups={"model": group}, group_ranks={"model": ranks})


def make_host_mesh(model: int = 1) -> Mesh:
    """Small serving mesh over the whole world (tests, examples)."""
    n = world_size()
    model = max(1, min(model, n))
    return make_serving_mesh(tp=model, dp=n // model)


def make_training_mesh(model: int = 1) -> Mesh:
    """(data = n / model, model) over the n ranks of the default process
    group: rank r is data index r // model and model index r % model.
    The mesh carries a process group for each axis (``GROUP_TIMEOUT_S``),
    made by every rank for every subgroup in one order, so every rank of
    the world must call it, in the same order as its other collectives.
    One rank (no process group) gives a (1, 1) mesh."""
    model = int(model)
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"training mesh: {n} ranks do not split into "
                         f"data x model={model}")
    data = n // model
    axes = (("data", data), ("model", model))
    if n == 1:
        return Mesh(axes, coords={"data": 0, "model": 0},
                    groups={"data": None, "model": None},
                    group_ranks={"data": (0,), "model": (0,)})
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    rank = dist.get_rank()
    groups, ranks_of = {}, {}
    for axis, members in (
            ("data", [tuple(range(m, n, model)) for m in range(model)]),
            ("model", [tuple(range(d * model, (d + 1) * model))
                       for d in range(data)])):
        for ranks in members:
            group = dist.new_group(list(ranks), timeout=timeout)
            if rank in ranks:
                groups[axis], ranks_of[axis] = group, ranks
    return Mesh(axes, coords={"data": rank // model, "model": rank % model},
                groups=groups, group_ranks=ranks_of)


def init_world(device: str) -> tuple:
    """Join the process group of a ``torchrun`` launch (its RANK,
    WORLD_SIZE and MASTER_ADDR/PORT environment), with a timeout: NCCL
    when every rank has a card of its own, else gloo (NCCL refuses two
    ranks on one card). Returns (rank, the device string of this rank);
    outside a launch of more than one rank, or when the process group is
    up already, (its rank, ``device``)."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), device
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world < 2:
        return 0, device
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    nccl = device.startswith("cuda") and torch.cuda.device_count() >= world
    if nccl:
        device = f"cuda:{local}"
        torch.cuda.set_device(local)    # NCCL's barrier uses the current
    dist.init_process_group(
        "nccl" if nccl else "gloo",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.get_rank(), device
