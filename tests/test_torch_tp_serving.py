"""Tensor-parallel serving of the port at TP 2 (reduced qwen2-1.5b, CPU).

The port of ``tests/test_tp_serving.py`` in a gloo world of two ranks
(``repro_torch.launch.local_world``, spawned once for the module, its
FileStore under ``tmp_path``; each collective times out after 60 s and
each call is joined with a deadline). Every rank serves the same
requests with half the pool's KV heads; the tests hold:

* byte identity: the tokens at TP 2, alone and composed with the fused
  decode horizon, speculative decode, the prefix cache and the stream
  scheduler, equal the port's own at TP 1 on the same seeded weights,
  and every rank returns the same results (the reference's file needs 4
  fake XLA devices, so a one-device run skips it; on jax 0.9 its sharded
  serves fail, ROADMAP.md section 3). The port at TP 1 equals the JAX
  engine on the same weights (``test_tp1_equals_jax_engine``);
* the pool is sharded: each local leaf holds N/2 heads, the ranks' head
  ranges tile the heads, ``pool_bytes_per_shard() * 2 == pool_bytes()``;
  NaN-poisoned free pages of both shards change no token;
* mesh resolution: an explicit ``tp`` must divide the kv heads, needs the
  paged layout and a process group of tp ranks; a ``mesh`` that
  disagrees with ``tp`` raises; ``REPRO_MESH_TP`` degrades silently;
* both routes of the head gather give the same bits, and host decisions
  that read a clock or a measured time (deadlines, the tuner's probes)
  are the first rank's on every rank.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.launch.local_world import LocalWorld
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TP = 2


def _cfg(arch="qwen2-1.5b", calib="none"):
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
    """The port's tokens at TP 1 (this process, no process group)."""
    return _serve(_cfg(arch), _prompts(4, seed=seed, shared=shared),
                  **dict(feat))[1]


def _checksum(params) -> int:
    """Exact checksum of a params tree's bits."""
    if isinstance(params, dict):
        return sum(_checksum(v) for v in params.values())
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = params.contiguous().view(ints[params.element_size()])
    return int(bits.to(torch.int64).sum())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = LocalWorld(TP, tmp_path_factory.mktemp("tp2_store"))
    yield w
    w.close()


# ------------------------------------------------------ functions per rank
def _rank_serve(arch, seed, shared, feat):
    eng, tok = _serve(_cfg(arch), _prompts(4, seed=seed, shared=shared),
                      tp=TP, **dict(feat))
    res = eng.results()
    return {"tokens": tok, "tp": eng.tp,
            "mesh_shape": dict(eng.mesh.shape),
            "status": {u: r.status for u, r in res.items()},
            "admitted": (list(eng.sched.admitted_uids)
                         if eng.sched is not None else None),
            "prefix_hits": (eng.prefix.hits if eng.prefix is not None
                            else None),
            "checksum": _checksum(eng.params)}


def _rank_validation():
    from repro_torch.launch.mesh import make_serving_mesh
    cfg = _cfg()
    mesh = make_serving_mesh(tp=TP)
    errors = []
    for kw in (dict(tp=3), dict(tp=TP, attn=AttnSpec(layout="dense")),
               dict(tp=1, mesh=mesh)):
        try:
            Engine(cfg, device="cpu", max_batch=1, max_len=32, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    eng = Engine(cfg, device="cpu", max_batch=1, max_len=32, mesh=mesh)
    return errors, eng.tp, dict(eng.mesh.shape)


def _rank_env_tp():
    cfg = _cfg()
    got = []
    try:
        for env, kw in (("2", {}), ("3", {}),
                        ("2", dict(attn=AttnSpec(layout="dense"))),
                        ("4", {})):
            os.environ["REPRO_MESH_TP"] = env
            got.append(Engine(cfg, device="cpu", max_batch=1, max_len=32,
                              **kw).tp)
    finally:
        os.environ.pop("REPRO_MESH_TP", None)
    got.append(Engine(cfg, device="cpu", max_batch=1, max_len=32,
                      tp=TP).tp)
    return got


def _rank_pool():
    from repro_torch.distribution.tp import POOL_HEAD_AXIS, pool_shardings
    cfg = _cfg()
    eng = Engine(cfg, device="cpu", max_batch=2, max_len=64,
                 prefill_buckets=(16, 32), tp=TP)
    pages = eng.pages
    full = {name: tuple(leaf.shape[:POOL_HEAD_AXIS[name]])
            + (cfg.n_kv_heads,) + tuple(leaf.shape[POOL_HEAD_AXIS[name] + 1:])
            for name, leaf in pages.cache.items()}
    shards = pool_shardings(eng.mesh, full)
    return {"per_shard": pages.pool_bytes_per_shard(),
            "pool": pages.pool_bytes(),
            "heads": {name: leaf.shape[POOL_HEAD_AXIS[name]]
                      for name, leaf in pages.cache.items()},
            "ranges": {name: (s.axis, s.start, s.stop)
                       for name, s in shards.items()}}


def _rank_summary():
    eng = Engine(_cfg(), device="cpu", max_batch=2, max_len=64,
                 prefill_buckets=(16, 32), tp=TP)
    eng.submit(Request(0, _prompts(1, seed=1)[0], max_new_tokens=4))
    eng.run()
    return eng.summary()


def _rank_poisoned():
    from repro_torch.core.quant import POISON_CODE
    eng = Engine(_cfg(), device="cpu", max_batch=2, max_len=96,
                 prefill_buckets=(16, 32, 64), tp=TP)
    for uid, p in enumerate(_prompts(2, seed=7)):
        eng.submit(Request(uid, p, max_new_tokens=5))
    eng.step()                        # admit + first decode
    free = list(eng.pages.allocator._free)
    assert free, "test needs unallocated pages"
    idx = torch.tensor(free)
    c = eng.pages.cache              # this rank's heads of every leaf
    c["k_pages"][:, idx] = POISON_CODE
    c["v_pages"][:, idx] = POISON_CODE
    c["k_scale"][:, idx] = float("nan")
    c["v_scale"][:, idx] = float("nan")
    res = eng.run()
    return {u: r.tokens for u, r in res.items()}, len(free)


def _rank_gather_routes():
    from repro_torch.distribution.tp import gather_heads, gather_route
    from repro_torch.launch.mesh import make_serving_mesh
    import torch.distributed as dist
    mesh = make_serving_mesh(tp=TP)
    g = torch.Generator().manual_seed(100 + dist.get_rank())
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        x = (torch.randn(3, 2, 5, 4, generator=g) * 50).to(dt)
        a = gather_heads(x, 1, mesh, route="all_gather")
        b = gather_heads(x, 1, mesh, route="broadcast")
        out[str(dt)] = (a.shape == b.shape and torch.equal(a, b)
                        and torch.equal(a.narrow(1, 2 * dist.get_rank(), 2),
                                        x), tuple(a.shape))
    return out, gather_route(mesh, "cpu")


def _rank_deadlines():
    """Rank 1 sleeps past a request's deadline before it steps: on its
    own clock it would cancel the request a step before rank 0 does."""
    import torch.distributed as dist
    eng = Engine(_cfg(), device="cpu", max_batch=2, max_len=96,
                 prefill_buckets=(16, 32, 64), tp=TP, stream_sched=True)
    for uid, p in enumerate(_prompts(4, seed=5)):
        eng.submit(Request(uid, p, max_new_tokens=5),
                   deadline_s=0.5 if uid == 1 else None)
    if dist.get_rank() == 1:
        time.sleep(1.0)
    res = eng.run()
    return {u: (r.status, r.tokens) for u, r in res.items()}, \
        eng.metrics["req_deadline"]


def _rank_cost_policy():
    from repro_torch.autotune import Tuner, reset_default_tuner
    from repro_torch.roofline.hardware import HOST_CPU
    try:
        eng, tok = _serve(_cfg(), _prompts(4, seed=3), tp=TP,
                          attn=AttnSpec(policy="cost"),
                          tuner=Tuner(hw=HOST_CPU, margin=1e9,
                                      probe_reps=1))
        return tok, dict(eng.tuner.decision), eng.tuner.probes
    finally:
        reset_default_tuner()


# --------------------------------------------------------- mesh resolution
def test_engine_tp_validation(world):
    cfg = _cfg()
    with pytest.raises(ValueError, match="divisible"):
        Engine(cfg, device="cpu", max_batch=1, max_len=32, tp=3)
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, device="cpu", max_batch=1, max_len=32, tp=2,
               attn=AttnSpec(layout="dense"))
    # no process group here: the mesh cannot be built
    with pytest.raises(RuntimeError, match="needs 2 ranks, have 1 — "
                       "launch with torchrun --nproc-per-node 2"):
        Engine(cfg, device="cpu", max_batch=1, max_len=32, tp=2)
    for errors, tp, shape in world.run(_rank_validation):
        assert "divisible" in errors[0]
        assert "paged" in errors[1]
        assert "model axis" in errors[2]
        assert tp == TP and shape == {"data": 1, "model": TP}


def test_env_default_degrades_silently(world, monkeypatch):
    monkeypatch.setenv("REPRO_MESH_TP", "2")
    # a world of one rank: the env default degrades to 1
    assert Engine(_cfg(), device="cpu", max_batch=1, max_len=32).tp == 1
    # in the world of two: 2 applies; 3 (2 kv heads) and the dense layout
    # and 4 (> the world) degrade; the explicit kwarg wins
    for got in world.run(_rank_env_tp):
        assert got == [2, 1, 1, 1, 2]


# ------------------------------------------------------------- byte identity
@pytest.mark.parametrize("tp,arch", [(2, "qwen2-1.5b")])
def test_tp_byte_identity(world, tp, arch):
    """Sharded decode must not change a single token: the gather
    concatenates exact per-shard head outputs, it never float-reduces."""
    from repro_torch.models import registry
    ref = _tp1(arch, 3)
    seeded = _checksum(registry.init_params(_cfg(arch), 0, "cpu"))
    for r in world.run(_rank_serve, arch, 3, 0, ()):
        assert r["tokens"] == ref, f"tp={tp} changed the generated tokens"
        assert r["tp"] == tp and r["mesh_shape"]["model"] == tp
        assert r["checksum"] == seeded


@pytest.mark.parametrize("feat", [
    {"decode_horizon": 4},
    {"spec_decode": True, "draft_len": 3},
    {"prefix_cache": True},
    {"stream_sched": True},
    pytest.param({"decode_horizon": 4, "spec_decode": True,
                  "prefix_cache": True, "stream_sched": True},
                 id="everything-on", marks=pytest.mark.slow),
])
def test_tp2_composes_with_serving_features(world, feat):
    shared = 32 if feat.get("prefix_cache") else 0
    key = tuple(sorted(feat.items()))
    ref = _tp1("qwen2-1.5b", 5, shared, key)
    ranks = world.run(_rank_serve, "qwen2-1.5b", 5, shared, key)
    for r in ranks:
        assert r["tokens"] == ref, \
            f"tp=2 + {feat} changed the generated tokens"
    # the ranks took the same host decisions
    assert ranks[0]["status"] == ranks[1]["status"]
    assert ranks[0]["admitted"] == ranks[1]["admitted"]
    if feat.get("prefix_cache"):
        # hits seed their request caches from both ranks' heads
        assert ranks[0]["prefix_hits"] > 0
        assert ranks[0]["prefix_hits"] == ranks[1]["prefix_hits"]


def test_tp1_equals_jax_engine():
    """The port at TP 1 serves the JAX engine's tokens on the same
    weights and traffic (the reference asserts TP == TP 1 itself)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.configs.base import reduced as jreduced
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro_torch.models import registry

    cfg = _cfg()
    jcfg = jreduced(jget("qwen2-1.5b"))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(enabled=True, calib="none"))

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else jnp.asarray(t.numpy()))

    jparams = tree(registry.init_params(cfg, 0, "cpu"))
    eng = JEngine(jcfg, params=jparams, max_batch=2, max_len=96,
                  prefill_buckets=(16, 32, 64))
    for uid, p in enumerate(_prompts(4, seed=3)):
        eng.submit(JRequest(uid, p, max_new_tokens=5))
    got = {u: list(map(int, r.tokens)) for u, r in eng.run().items()}
    assert jax.devices()[0].platform == "cpu"
    assert _tp1("qwen2-1.5b", 3) == got


# ------------------------------------------------------------- pool sharding
def test_pool_sharded_not_replicated(world):
    cfg = _cfg()
    ranks = world.run(_rank_pool)
    for m, r in enumerate(ranks):
        assert r["per_shard"] * TP == r["pool"]
        for name, n in r["heads"].items():
            assert n * TP == cfg.n_kv_heads, \
                f"{name}: {n} local heads, not n_kv_heads / tp"
            ax, lo, hi = r["ranges"][name]
            assert (lo, hi) == (m * n, (m + 1) * n)
    # the unsharded pool holds the same bytes in all
    eng = Engine(cfg, device="cpu", max_batch=2, max_len=64,
                 prefill_buckets=(16, 32))
    assert eng.pages.pool_bytes() == ranks[0]["pool"]


def test_summary_reports_mesh(world):
    for m in world.run(_rank_summary):
        assert m["tp"] == 2
        assert m["mesh_shape"] == {"data": 1, "model": 2}
        assert m["cache_bytes_pool_per_shard"] * 2 == m["cache_bytes_pool"]
        assert m["collective_bytes_per_layer"] > 0


def test_poisoned_free_pages_never_read_per_shard(world):
    """The no-DMA contract holds on the SHARDED pool: free pages of both
    shards NaN-poisoned through both sentinel channels, tokens
    unchanged (decode gathers only table-mapped pages on each shard)."""
    _, clean = _serve(_cfg(), _prompts(2, seed=7))
    for got, n_free in world.run(_rank_poisoned):
        assert n_free > 0
        assert got == clean, "NaN leaked from never-referenced sharded pages"


# ------------------------------------------------- collectives and decisions
def test_gather_routes_bit_equal(world):
    """The broadcast route (gloo's for CUDA tensors) gives the bits of
    all_gather_into_tensor's, in every dtype; gloo on the CPU takes the
    all-gather."""
    for out, route in world.run(_rank_gather_routes):
        assert route == "all_gather"
        for dt, (same, shape) in out.items():
            assert same, f"{dt}: the routes differ"
            assert shape == (3, 2 * TP, 5, 4)


def test_tp2_clock_decisions_agree(world):
    """A deadline is read on the first rank's clock: rank 1, which slept
    past it before its first step, cancels at the same step as rank 0."""
    ranks = world.run(_rank_deadlines)
    assert ranks[0] == ranks[1]
    (res, n_deadline) = ranks[0]
    assert res[1][0] == "deadline" and n_deadline == 1
    assert all(res[u][0] == "ok" for u in (0, 2, 3))


def test_tp2_cost_policy_probes_agree(world):
    """The tuner's probes time each candidate on every rank; the first
    rank's times decide, so every rank settles on the same backends and
    serves the same tokens."""
    ranks = world.run(_rank_cost_policy)
    assert ranks[0] == ranks[1]
    tok, decision, probes = ranks[0]
    assert probes > 0
    assert all(":tp2" in k for k, _ in decision.items() if "decode" in k)
    assert set(tok) == {0, 1, 2, 3}
