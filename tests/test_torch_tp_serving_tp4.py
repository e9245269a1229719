"""Tensor-parallel serving of the port at TP 4 (reduced olmoe-1b-7b, CPU).

The TP-4 half of the port of ``tests/test_tp_serving.py``, in a gloo
world of four ranks (``repro_torch.launch.local_world``, spawned once for
the module, its FileStore under ``tmp_path``, each collective timing out
after 60 s): the serving mesh's shapes over the world, and reduced
olmoe-1b-7b (4 kv heads, one a rank) serving the tokens of the port at
TP 1, alone and with the fused horizon, speculative decode, the prefix
cache and the stream scheduler all on, every rank the same results.
``tests/test_torch_tp_serving.py`` holds TP 2 and the port at TP 1
against the JAX engine.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.local_world import LocalWorld
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

WORLD = 4


def _cfg(arch="olmoe-1b-7b", calib="none"):
    cfg = reduced(get_config(arch))
    return cfg.replace(hdp=cfg.hdp.replace(enabled=True, calib=calib))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, size=shared).tolist()
    return [pre + rng.integers(1, vocab,
                               size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve(cfg, prompts, *, max_new=5, **kw):
    eng = Engine(cfg, device="cpu", max_batch=2, max_len=96,
                 prefill_buckets=(16, 32, 64), **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=max_new))
    res = eng.run()
    return eng, {u: r.tokens for u, r in res.items()}


@functools.lru_cache(maxsize=None)
def _tp1(arch, seed, shared=0, feat=()):
    return _serve(_cfg(arch), _prompts(4, seed=seed, shared=shared),
                  **dict(feat))[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = LocalWorld(WORLD, tmp_path_factory.mktemp("tp4_store"))
    yield w
    w.close()


# ------------------------------------------------------ functions per rank
def _rank_meshes():
    from repro_torch.launch.mesh import make_serving_mesh
    import torch.distributed as dist
    out = []
    for tp, dp in ((2, 1), (2, 2), (4, 1)):
        m = make_serving_mesh(tp=tp, dp=dp)
        out.append((m.shape, dict(m.coords), m.model_ranks))
    errors = []
    for tp, dp, exc in ((64, 64, RuntimeError), (0, 1, ValueError)):
        try:
            make_serving_mesh(tp=tp, dp=dp)
            errors.append(None)
        except exc as e:
            errors.append(str(e))
    return dist.get_rank(), out, errors


def _rank_serve(arch, tp, seed, shared, feat):
    eng, tok = _serve(_cfg(arch), _prompts(4, seed=seed, shared=shared),
                      tp=tp, **dict(feat))
    return {"tokens": tok, "tp": eng.tp,
            "mesh_shape": dict(eng.mesh.shape),
            "local_heads": eng.pages.cache["k_pages"].shape[3],
            "status": {u: r.status for u, r in eng.results().items()}}


# --------------------------------------------------------- mesh construction
def test_make_serving_mesh_shape(world):
    for rank, meshes, errors in world.run(_rank_meshes):
        (s21, c21, r21), (s22, c22, r22), (s41, c41, r41) = meshes
        # (dp=1, tp=2): two copies, over ranks 0-1 and 2-3
        assert s21 == {"data": 1, "model": 2}
        assert c21 == {"data": 0, "model": rank % 2}
        assert r21 == (2 * (rank // 2), 2 * (rank // 2) + 1)
        assert s22 == {"data": 2, "model": 2}
        assert c22 == {"data": rank // 2, "model": rank % 2}
        assert r22 == (2 * (rank // 2), 2 * (rank // 2) + 1)
        assert s41 == {"data": 1, "model": 4} and r41 == (0, 1, 2, 3)
        assert "needs 4096 ranks, have 4" in errors[0]
        assert "must be >= 1" in errors[1]


def _rank_mesh_tp3():
    from repro_torch.launch.mesh import make_serving_mesh
    try:
        return make_serving_mesh(tp=3).model_ranks
    except RuntimeError as e:
        return str(e)


def test_serving_mesh_ranks_outside(world):
    """(dp=1, tp=3) fits once in a world of 4: rank 3 raises."""
    got = world.run(_rank_mesh_tp3)
    assert got[:3] == [(0, 1, 2)] * 3
    assert "outside the serving meshes" in got[3]


# ------------------------------------------------------------- byte identity
@pytest.mark.parametrize("tp,arch", [(4, "olmoe-1b-7b")])
def test_tp_byte_identity(world, tp, arch):
    """Sharded decode must not change a single token: the gather
    concatenates exact per-shard head outputs, it never float-reduces."""
    ref = _tp1(arch, 3)
    for r in world.run(_rank_serve, arch, tp, 3, 0, ()):
        assert r["tokens"] == ref, f"tp={tp} changed the generated tokens"
        assert r["tp"] == tp and r["mesh_shape"]["model"] == tp
        assert r["local_heads"] * tp == _cfg(arch).n_kv_heads


def test_tp4_everything_on(world):
    feat = tuple(sorted({"decode_horizon": 4, "spec_decode": True,
                         "prefix_cache": True,
                         "stream_sched": True}.items()))
    ref = _tp1("olmoe-1b-7b", 5, 32, feat)
    ranks = world.run(_rank_serve, "olmoe-1b-7b", 4, 5, 32, feat)
    for r in ranks:
        assert r["tokens"] == ref
        assert r["status"] == ranks[0]["status"]
