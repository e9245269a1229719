"""Data-parallel replicas of tensor-parallel engines (reduced qwen2-1.5b,
CPU, a gloo world of two ranks).

The port of the ``ReplicaSet`` tests of ``tests/test_tp_serving.py``
(``test_replicaset_byte_identity_and_affinity``,
``test_replicaset_dp2_tp2_compose``,
``test_replicaset_least_loaded_dispatch``) with every replica sharded
over the two ranks (``tp=2``, or ``REPRO_MESH_TP=2``, the reference's CI
leg): each rank holds both replicas, each with half of its pool's heads,
and dispatches alike. The tokens equal one unsharded port engine's on
the same seeded weights, and both ranks pick the same home replica for
every request. The ranks run in ``repro_torch.launch.local_world``,
spawned once for the module (FileStore under ``tmp_path``, 60 s
collective timeout, calls joined with a deadline).
``tests/test_torch_replica.py`` holds the port's unsharded set against
the JAX package's.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.local_world import LocalWorld
from repro_torch.serving import Engine, ReplicaSet, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TP = 2
KW = dict(device="cpu", max_batch=2, max_len=96, prefill_buckets=(16, 32, 64))


def _cfg(arch="qwen2-1.5b", calib="none"):
    cfg = reduced(get_config(arch))
    return cfg.replace(hdp=cfg.hdp.replace(enabled=True, calib=calib))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, size=shared).tolist()
    return [pre + rng.integers(1, vocab,
                               size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _single(seed, shared, prefix_cache, n):
    """One unsharded port engine's tokens (this process)."""
    eng = Engine(_cfg(), prefix_cache=prefix_cache, **KW)
    for uid, p in enumerate(_prompts(n, seed=seed, shared=shared)):
        eng.submit(Request(uid, p, max_new_tokens=5))
    return {u: r.tokens for u, r in eng.run().items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = LocalWorld(TP, tmp_path_factory.mktemp("tp_replica_store"))
    yield w
    w.close()


# ------------------------------------------------------ functions per rank
def _rank_affinity():
    os.environ["REPRO_MESH_TP"] = str(TP)
    try:
        rs = ReplicaSet.build(_cfg(), 2, prefix_cache=True, **KW)
    finally:
        os.environ.pop("REPRO_MESH_TP")
    homes, got = {}, {}
    for uid, p in enumerate(_prompts(6, seed=9, shared=16)):
        homes[uid] = rs.engines.index(
            rs.submit(Request(uid, p, max_new_tokens=5)))
    for r in rs.serve():
        got[r.uid] = r.tokens
    s = rs.summary()
    return {"tokens": got, "homes": homes, "dp": s["dp"], "tp": s["tp"],
            "engine_tp": rs.engines[0].tp,
            "per_replica": s["requests_per_replica"]}


def _rank_dp2_tp2():
    rs = ReplicaSet.build(_cfg(), 2, tp=TP, **KW)
    got = {r.uid: r.tokens
           for r in rs.serve([Request(u, p, max_new_tokens=5)
                              for u, p in enumerate(_prompts(4, seed=11))])}
    s = rs.summary()
    keys = ("dp", "tp", "mesh_shape", "cache_bytes_pool_per_shard",
            "collective_bytes_per_layer")
    return got, {k: s[k] for k in keys}, rs.engines[0].pages.pool_bytes(), \
        rs.engines[0].params is rs.engines[1].params


def _rank_least_loaded():
    os.environ["REPRO_MESH_TP"] = str(TP)
    try:
        rs = ReplicaSet.build(_cfg(), 2, device="cpu", max_batch=2,
                              max_len=64, prefill_buckets=(16, 32))
    finally:
        os.environ.pop("REPRO_MESH_TP")
    picked = [rs.engines.index(rs.submit(Request(u, p, max_new_tokens=3)))
              for u, p in enumerate(_prompts(4, seed=13))]
    rs.run()
    return picked, sorted(rs.results()), [e.tp for e in rs.engines]


# ---------------------------------------------------------------- replicas
def test_replicaset_byte_identity_and_affinity(world):
    ref = _single(9, 16, True, 6)
    ranks = world.run(_rank_affinity)
    for r in ranks:
        assert r["tokens"] == ref, \
            "replica dispatch changed the generated tokens"
        assert sum(r["per_replica"]) == 6
        # tp reflects each replica's engine: sharded under the env leg
        assert r["dp"] == 2 and r["tp"] == r["engine_tp"] == TP
    # every rank sent every request to the same replica
    assert ranks[0]["homes"] == ranks[1]["homes"]


def test_replicaset_dp2_tp2_compose(world):
    ref = _single(11, 0, None, 4)
    for got, s, pool, shared in world.run(_rank_dp2_tp2):
        assert got == ref, "dp=2 x tp=2 changed the generated tokens"
        assert s["dp"] == 2 and s["tp"] == 2
        assert s["mesh_shape"] == {"data": 1, "model": 2}
        assert s["cache_bytes_pool_per_shard"] * 2 == pool
        assert s["collective_bytes_per_layer"] > 0
        assert shared, "replicas must share one params dict"


def test_replicaset_least_loaded_dispatch(world):
    ranks = world.run(_rank_least_loaded)
    for picked, uids, tps in ranks:
        # no prefix cache: dispatch alternates by load
        assert picked[0] != picked[1]
        assert uids == [0, 1, 2, 3]
        assert tps == [TP, TP]
    assert ranks[0][0] == ranks[1][0]
