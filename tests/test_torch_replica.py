"""Port parity of ``ReplicaSet`` (data-parallel replicas, failover) on
reduced qwen2-1.5b (CPU, plain kernel versions).

The port of the ``ReplicaSet`` tests of ``tests/test_faults.py``
(``test_replica_failover_exactly_once``, ``test_all_replicas_dead_raises``,
``test_chaos_identity_acceptance``) and of the replica tests of
``tests/test_tp_serving.py`` (``test_replicaset_byte_identity_and_affinity``,
``test_replicaset_least_loaded_dispatch``). Each builds the port's set
and the JAX package's on the same weights, traffic and fault plan (JAX
on the int8 pool and the XLA backends), and holds the port to the
reference: each uid's home replica, ``health``, ``failovers``,
``requests_failed_over``, ``requests_per_replica`` and the tokens; and,
as the reference tests do, every request the faults did not target to a
fault-free run of one port engine.

``test_replicaset_dp2_tp2_compose`` is not ported: it composes replicas
with tensor parallelism (``tp=2``, a "model" mesh axis), which the port
gets with ROADMAP.md section 1, item 8.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import ReplicaSet as JReplicaSet
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving import (Engine, ReplicaSet, Request,
                                 SchedulerConfig)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

FAULTS_KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, size=shared).tolist()
    return [pre + rng.integers(1, vocab,
                               size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _setup(hdp):
    """(port config, JAX config, JAX weights, port weights): HDP off as
    ``tests/test_faults.py``'s ``_qwen``, or on with ``calib="none"`` as
    ``tests/test_tp_serving.py``'s ``_cfg``."""
    cfg, jcfg = reduced(get_config("qwen2-1.5b")), \
        jax_reduced(jax_get_config("qwen2-1.5b"))
    cfg, jcfg = (c.replace(hdp=c.hdp.replace(enabled=hdp, calib="none"))
                 for c in (cfg, jcfg))
    tree = _numpy_tree(registry.init_params(cfg, 0, "cpu"))
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def qwen():
    return _setup(hdp=False)


@pytest.fixture(scope="module")
def qwen_hdp():
    return _setup(hdp=True)


def _build(setup, dp, *, sched=None, jsched=None, **kw):
    """The port's set and the JAX package's, each with its own injector
    of the plan ``kw["faults"]``."""
    cfg, jcfg, jparams, params = setup
    rs = ReplicaSet.build(cfg, dp, params=params, device="cpu",
                          sched=sched, **kw)
    jrs = JReplicaSet.build(jcfg, dp, params=jparams, sched=jsched,
                            attn=JSpec(backend="xla", kv_dtype="int8"), **kw)
    return rs, jrs


def _homes(rs):
    return {u: rs.engines.index(e) for u, e in rs._home.items()}


def _same_as_jax(rs, jrs, out, jout):
    assert sorted(out) == sorted(jout)
    for u in jout:
        r, j = out[u], jout[u]
        assert r.tokens == j.tokens, f"req {u}: {r.tokens} != {j.tokens}"
        assert (r.status, r.complete, r.preemptions) == \
            (j.status, j.complete, j.preemptions), f"req {u}"
    assert _homes(rs) == _homes(jrs)
    s, js = rs.summary(), jrs.summary()
    for k in ("dp", "health", "failovers", "requests_failed_over",
              "requests_per_replica", "replica_queue_depth",
              "replica_inflight", "tokens_out", "fault_plan",
              "faults_fired", "kv_dtype", "kv_scale"):
        assert s.get(k) == js.get(k), f"{k}: port {s.get(k)} vs JAX {js.get(k)}"
    assert s["tp"] == 1
    for e, je in zip(rs.engines, jrs.engines):
        for c in ("faults_injected", "req_errors", "sched_preempted",
                  "sched_deferred", "decode_steps", "tokens_out"):
            assert e.metrics[c] == je.metrics[c], c


def _fault_free(setup, reqs, **kw):
    """Every request of ``reqs`` on one port engine with no fault plan
    (the tokens of a run that was never interrupted)."""
    cfg, _, _, params = setup
    eng = Engine(cfg, params, device="cpu", faults="",
                 **{**FAULTS_KW, **kw})
    for r in reqs:
        eng.submit(Request(r.uid, list(r.prompt),
                           max_new_tokens=r.max_new_tokens))
    return {u: r.tokens for u, r in eng.run().items()}


# ------------------------------------------------- tests/test_faults.py
def test_replica_failover_exactly_once(qwen):
    prompts = _prompts(4, seed=30)
    rs, jrs = _build(qwen, 2, stream_sched=True, faults="kill@1:replica=0",
                     **FAULTS_KW)
    for s, cls in ((rs, Request), (jrs, JRequest)):
        for uid, p in enumerate(prompts):
            s.submit(cls(uid, p, max_new_tokens=10))
    out, jout = rs.run(), jrs.run()
    s = rs.summary()
    assert s["health"] == ["dead", "up"]
    assert s["failovers"] == 1
    assert s["requests_failed_over"] >= 1
    assert s["faults_fired"] >= 1
    assert len(s["replica_queue_depth"]) == 2
    assert len(s["replica_inflight"]) == 2
    assert len(s["replica_last_step_s"]) == 2
    ref = _fault_free(qwen, [Request(u, p, max_new_tokens=10)
                             for u, p in enumerate(prompts)])
    for uid in range(4):           # moved requests resume exactly
        assert out[uid].complete and out[uid].tokens == ref[uid], f"req {uid}"
    assert sorted(out) == [0, 1, 2, 3]   # exactly once each, no dupes
    rs.engines[1].pages.allocator.assert_drained()  # the survivor leaks none
    _same_as_jax(rs, jrs, out, jout)


def test_all_replicas_dead_raises(qwen):
    rs, jrs = _build(qwen, 1, stream_sched=True, faults="kill@0:replica=0",
                     **dict(FAULTS_KW, max_batch=1))
    prompt = _prompts(1, seed=31)[0]
    for s, cls in ((rs, Request), (jrs, JRequest)):
        s.submit(cls(0, prompt, max_new_tokens=4))
        with pytest.raises(RuntimeError, match="every replica is dead"):
            s.run()
    assert rs.health == jrs.health == ["dead"]


def test_chaos_identity_acceptance(qwen):
    """The reference's acceptance gate: one seeded plan combining a
    replica kill, a NaN-poisoned slot, an injected pool exhaustion and a
    priority preemption. Every request the faults did not target equals
    a fault-free run, the targeted one comes back ``status="error"``,
    the surviving allocator drains, and all of it equals the JAX set."""
    prompts = _prompts(7, lo=10, hi=20, seed=32)
    plan = "slow@0:s=0.005;exhaust@2;nan@1:uid=3;kill@3:replica=0"
    rs, jrs = _build(
        qwen, 2, stream_sched=True, faults=plan,
        sched=SchedulerConfig(preempt_after=2, watchdog_steps=80),
        jsched=JSchedulerConfig(preempt_after=2, watchdog_steps=80),
        **FAULTS_KW)
    for s, cls in ((rs, Request), (jrs, JRequest)):
        for uid in range(6):
            s.submit(cls(uid, prompts[uid], max_new_tokens=12))
        # 5 pre-steps: replica 0 dies at fleet step 3 and fails its work
        # over, and by step 5 both survivor slots hold long requests with
        # more queued, so the high-priority arrival must preempt
        for _ in range(5):
            s.step()
        s.submit(cls(6, prompts[6], max_new_tokens=4, priority=1))
    out, jout = rs.run(max_steps=400), jrs.run(max_steps=400)

    s = rs.summary()
    assert s["failovers"] == 1 and s["health"].count("dead") == 1
    assert rs.faults is not None and not rs.faults.pending  # plan consumed
    assert sum(e.metrics["sched_preempted"] for e in rs.engines) >= 1
    assert out[3].status == "error" and not out[3].complete
    ref = _fault_free(qwen, [Request(u, prompts[u],
                                     max_new_tokens=12 if u < 6 else 4)
                             for u in range(7) if u != 3])
    for uid in ref:
        assert out[uid].status == "ok" and out[uid].complete, f"req {uid}"
        assert out[uid].tokens == ref[uid], f"req {uid}"
    assert sorted(out) == list(range(7))   # none lost, none served twice
    for i, eng in enumerate(rs.engines):   # survivors drain to zero
        if rs.health[i] == "up":
            eng.pages.allocator.assert_drained()
    _same_as_jax(rs, jrs, out, jout)
    assert rs.faults.summary() == jrs.faults.summary()


def test_failover_resume_parts_like_jax(qwen_hdp):
    """With HDP on, a moved request's recompute resume re-prefills its
    generated tokens, whose block-tile scout prunes other blocks than the
    decode's per-step scout did, so it may part from the uninterrupted
    run after its failover, as a preempted request does (ROADMAP.md
    section 3): in the JAX package as in the port, token for token.
    Requests never moved equal the uninterrupted run, and a moved one
    does up to its failover."""
    kw = dict(max_batch=2, max_len=96, prefill_buckets=(16, 32, 64))
    prompts = _prompts(4, lo=20, hi=40, seed=35)
    rs, jrs = _build(qwen_hdp, 2, faults="kill@2:replica=0", **kw)
    made = []
    for s, cls in ((rs, Request), (jrs, JRequest)):
        for uid, p in enumerate(prompts):
            s.submit(cls(uid, p, max_new_tokens=24))
        for _ in range(2):
            s.step()
        made.append({st["req"].uid: len(st["generated"])
                     for st in s.engines[0]._active.values()})
    out, jout = rs.run(), jrs.run()
    _same_as_jax(rs, jrs, out, jout)
    cut = made[0]
    assert cut == made[1] and set(cut) == rs._failed_over == {0, 2}
    ref = _fault_free(qwen_hdp, [Request(u, p, max_new_tokens=24)
                                 for u, p in enumerate(prompts)], **kw)
    parted = sorted(u for u in out if out[u].tokens != ref[u])
    assert parted and set(parted) <= set(cut)
    for u, n in cut.items():       # identical up to the failover
        assert out[u].tokens[:n] == ref[u][:n]


# --------------------------------------------- tests/test_tp_serving.py
def test_replicaset_byte_identity_and_affinity(qwen_hdp):
    kw = dict(max_batch=2, max_len=96, prefill_buckets=(16, 32, 64))
    prompts = _prompts(6, seed=9, shared=16)
    reqs = [Request(u, p, max_new_tokens=5) for u, p in enumerate(prompts)]
    ref = _fault_free(qwen_hdp, reqs, prefix_cache=True, **kw)
    rs, jrs = _build(qwen_hdp, 2, prefix_cache=True, **kw)
    got, jgot = {}, {}
    for s, cls, g in ((rs, Request, got), (jrs, JRequest, jgot)):
        for uid, p in enumerate(prompts):
            s.submit(cls(uid, p, max_new_tokens=5))
        for r in s.serve():
            g[r.uid] = r
    assert {u: r.tokens for u, r in got.items()} == ref, \
        "replica dispatch changed the generated tokens"
    assert list(got) == list(jgot)      # the merged finish order
    counts = rs.summary()["requests_per_replica"]
    assert sum(counts) == len(prompts)
    s = rs.summary()
    assert s["dp"] == 2 and s["tp"] == 1
    assert sum(e.prefix.hits for e in rs.engines) == \
        sum(e.prefix.hits for e in jrs.engines) > 0
    _same_as_jax(rs, jrs, got, jgot)


def test_replicaset_least_loaded_dispatch(qwen):
    rs, jrs = _build(qwen, 2, **FAULTS_KW)
    prompts = _prompts(4, seed=13)
    picked = [rs.submit(Request(u, p, max_new_tokens=3))
              for u, p in enumerate(prompts)]
    jpicked = [jrs.submit(JRequest(u, p, max_new_tokens=3))
               for u, p in enumerate(prompts)]
    # no prefix cache: dispatch alternates by load
    assert picked[0] is not picked[1]
    assert [rs.engines.index(e) for e in picked] == \
        [jrs.engines.index(e) for e in jpicked]
    out, jout = rs.run(), jrs.run()
    assert sorted(rs.results()) == [0, 1, 2, 3]
    _same_as_jax(rs, jrs, out, jout)


# ------------------------------------------------------------ the port's
def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def test_replicas_share_param_tensors(qwen):
    """One params dict for the fleet: every replica's leaves are the same
    tensors (equal ``data_ptr()``), not copies; pools and slot buffers
    are each replica's own."""
    cfg = qwen[0]
    rs = ReplicaSet.build(cfg, 3, seed=4, device="cpu", **FAULTS_KW)
    e0 = rs.engines[0]
    leaves0 = _leaves(e0.params)
    assert len(leaves0) > 10
    for e in rs.engines[1:]:
        assert e.params is e0.params
        assert [t.data_ptr() for t in _leaves(e.params)] == \
            [t.data_ptr() for t in leaves0]
        assert e.pages.cache["k_pages"].data_ptr() != \
            e0.pages.cache["k_pages"].data_ptr()
        assert e._act.data_ptr() != e0._act.data_ptr()
    drawn = _leaves(Engine(cfg, seed=4, device="cpu", **FAULTS_KW).params)
    assert all(torch.equal(a, b) for a, b in zip(drawn, leaves0))
    with pytest.raises(ValueError, match="dp must be >= 1"):
        ReplicaSet.build(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="at least one engine"):
        ReplicaSet([])
