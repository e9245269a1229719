"""Port parity of fault injection and deadlines on reduced qwen2-1.5b (CPU,
plain kernel versions).

The port of the tests of ``tests/test_faults.py`` that inject faults or
expire deadlines on one engine (the lifecycle tests without injection
are in ``test_torch_lifecycle.py``, the ``ReplicaSet`` ones in
``test_torch_replica.py``). Each serve runs on the port's engine and on
the JAX engine (int8 pool, XLA backends) with the same weights, traffic
and fault plan, and the tokens, statuses, the ``faults_injected``,
``req_deadline``, ``req_errors``, ``sched_deferred`` and
``accepted_tokens`` counters and the injector's ``summary()`` must equal
the reference's; every untargeted request must also equal a fault-free
run of the port, and the pool must drain.

Where the reference asserts ``not eng.pages.donated`` after an injected
step error (its unwind restores the donated cache handle), the port,
which writes in place and donates nothing, asserts what its unwind must
give instead: every static buffer of the decode step (slot state,
history, step index, table rows, write floors, the NaN mask) holds what
it held before the failed step, the pool tensors keep their
``data_ptr()``, and no graph is captured again.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import faults as jfaults
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving import Engine, InjectedFault, Request
from repro_torch.serving.faults import (FAULT_ENV, FaultInjector, FaultPlan,
                                        coerce_injector)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

#: the counters the fault paths move, equal to the reference's
COUNTERS = ("faults_injected", "req_deadline", "req_errors", "req_cancelled",
            "sched_deferred", "accepted_tokens", "decode_steps",
            "tokens_out", "prefill_calls")


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _dense(cfg):
    return cfg.replace(hdp=cfg.hdp.replace(enabled=False))


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def qwen():
    cfg = _dense(reduced(get_config("qwen2-1.5b")))
    jcfg = _dense(jax_reduced(jax_get_config("qwen2-1.5b")))
    tree = _numpy_tree(registry.init_params(cfg, 0, "cpu"))
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(cfg, tree, "cpu")


BASE_KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
               prefix_cache=False, spec_decode=False)


def _pair(setup, faults=None, **kw):
    """The port's engine and the JAX engine on the same weights, each
    with its own injector of the plan ``faults``."""
    cfg, jcfg, jparams, params = setup
    kw = {**BASE_KW, **kw}
    eng = Engine(cfg, params, device="cpu", faults=faults, **kw)
    jeng = JEngine(jcfg, params=jparams, faults=faults,
                   attn=JSpec(backend="xla", kv_dtype="int8"), **kw)
    return eng, jeng


def _fault_free(setup, reqs, **kw):
    """The same traffic on a port engine with no fault plan."""
    cfg, _, _, params = setup
    eng = Engine(cfg, params, device="cpu", faults="", **{**BASE_KW, **kw})
    for r in reqs:
        eng.submit(Request(r.uid, list(r.prompt),
                           max_new_tokens=r.max_new_tokens))
    return {u: r.tokens for u, r in eng.run().items()}


def _submit_both(eng, jeng, prompts, max_new):
    for e, cls in ((eng, Request), (jeng, JRequest)):
        for uid, p in enumerate(prompts):
            e.submit(cls(uid, p, max_new_tokens=max_new))


def _same_as_jax(eng, jeng, out, jout):
    assert sorted(out) == sorted(jout)
    for u in jout:
        r, j = out[u], jout[u]
        assert r.tokens == j.tokens, f"req {u}: {r.tokens} != {j.tokens}"
        assert (r.status, r.complete, r.preemptions, r.decode_steps) == \
            (j.status, j.complete, j.preemptions, j.decode_steps), f"req {u}"
    for c in COUNTERS:
        assert eng.metrics[c] == jeng.metrics[c], \
            f"{c}: port {eng.metrics[c]} vs JAX {jeng.metrics[c]}"
    assert (eng.faults is None) == (jeng.faults is None)
    if eng.faults is not None:
        assert eng.faults.summary() == jeng.faults.summary()
        s, js = eng.summary(), jeng.summary()
        assert (s["fault_plan"], s["faults_fired"]) == \
            (js["fault_plan"], js["faults_fired"])


# --------------------------------------------------------------- harness
GOOD_SPECS = ("slow@0:s=0.01;exhaust@2;nan@3:uid=7;error@4;kill@5:replica=1",
              "kill@5:replica=1;error@4 ; nan@3:uid=7", "exhaust@0", "",
              "slow@2:s=1.5e-3,uid=4")
BAD_SPECS = ("frobnicate@1", "nan@1", "kill@1", "error", "slow@1",
             "error@-1", "nan@1:uid", "nan@1:who=2", "error@x",
             "slow@1:s=0")


def test_fault_plan_parse_roundtrip():
    spec = "slow@0:s=0.01;exhaust@2;nan@3:uid=7;error@4;kill@5:replica=1"
    plan = FaultPlan.parse(spec)
    assert len(plan) == 5
    assert plan.spec == spec                    # events sort by step
    assert FaultPlan.parse(plan.spec).spec == plan.spec
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("frobnicate@1")
    with pytest.raises(ValueError, match="uid"):
        FaultPlan.parse("nan@1")
    with pytest.raises(ValueError, match="replica"):
        FaultPlan.parse("kill@1")
    with pytest.raises(ValueError, match="not 'kind@step"):
        FaultPlan.parse("error")


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plan_parses_like_jax(spec):
    plan, jplan = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert plan.spec == jplan.spec and len(plan) == len(jplan)
    assert [vars(e) for e in plan.events] == [vars(e) for e in jplan.events]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_rejects_like_jax(spec):
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(spec)
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_injector_fires_each_event_once():
    def drive(inj, err):
        out = [inj.pool_exhausted(0), inj.pool_exhausted(1),
               inj.pool_exhausted(5),   # at or after the scheduled step
               inj.pool_exhausted(5),   # consumed: fires exactly once
               inj.nan_uids(3, {4}),    # uid 5 not live: stays pending
               inj.nan_uids(3, {4, 5}), inj.nan_uids(3, {4, 5}),
               list(inj.pending), inj.summary()]
        with pytest.raises(err):
            type(inj)("error@0").step_error(0)
        return out

    spec = "exhaust@2;nan@1:uid=5"
    got = drive(FaultInjector(spec), InjectedFault)
    assert got[:7] == [False, False, True, False, [], [5], []]
    assert not got[7]
    assert got == drive(jfaults.FaultInjector(spec), jfaults.InjectedFault)
    inj = FaultInjector("slow@1:s=0.001;kill@2:replica=1;kill@9:replica=0")
    inj.sleep(0)
    assert inj.kills(3) == [1] and len(inj.fired) == 1
    inj.sleep(1)
    assert [e.kind for e in inj.fired] == ["kill", "slow"]
    assert [e.spec for e in inj.pending] == ["kill@9:replica=0"]


def test_coerce_injector_env_fallback(monkeypatch):
    assert FAULT_ENV == jfaults.FAULT_ENV == "REPRO_FAULT_PLAN"
    monkeypatch.delenv(FAULT_ENV, raising=False)
    assert coerce_injector(None) is None
    assert coerce_injector("") is None
    monkeypatch.setenv(FAULT_ENV, "exhaust@1")
    inj = coerce_injector(None)
    assert inj is not None and inj.plan.spec == "exhaust@1"
    assert coerce_injector(None, env=False) is None
    assert coerce_injector(inj) is inj    # injectors pass through shared
    plan = FaultPlan.parse("error@3")
    assert coerce_injector(plan).plan is plan
    assert coerce_injector(FaultPlan()) is None


def test_engine_reads_fault_plan_env(qwen, monkeypatch):
    cfg, _, _, params = qwen
    monkeypatch.setenv(FAULT_ENV, "nan@0:uid=0")
    eng = Engine(cfg, params, device="cpu", **BASE_KW)
    assert eng.faults is not None and eng.faults.plan.spec == "nan@0:uid=0"
    assert Engine(cfg, params, device="cpu", faults="", **BASE_KW).faults \
        is None


# ------------------------------------------------------------ deadlines
def test_deadline_and_queue_wait_expiry(qwen):
    prompts = _prompts(3, seed=22)
    eng, jeng = _pair(qwen, max_batch=1, stream_sched=True)
    for e, cls in ((eng, Request), (jeng, JRequest)):
        e.submit(cls(0, prompts[0], max_new_tokens=8))
        # expires at step 0's check: the deadline is already past
        e.submit(cls(1, prompts[1], max_new_tokens=8), deadline_s=0.0)
        # expires while queued behind the single slot
        e.submit(cls(2, prompts[2], max_new_tokens=8),
                 max_queue_wait_s=0.0)
    out, jout = eng.run(), jeng.run()
    assert out[0].status == "ok" and out[0].complete
    assert out[1].status == "deadline" and not out[1].complete
    assert out[2].status == "deadline" and not out[2].complete
    assert "max_queue_wait_s" in out[2].error
    assert eng.metrics["req_deadline"] == 2
    assert not eng._deadlines
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)
    assert out[0].tokens == _fault_free(
        qwen, [Request(0, prompts[0], max_new_tokens=8)])[0]


def test_deadline_expires_while_decoding(qwen):
    """A deadline that passes after the request's slot is armed: the
    step's check cancels the active slot (its device state parked), its
    batchmate goes on unchanged."""
    prompts = _prompts(2, seed=33)
    wait = 0.5
    eng, jeng = _pair(qwen, stream_sched=True, decode_horizon=4)
    outs = []
    for e, cls in ((eng, Request), (jeng, JRequest)):
        e.submit(cls(0, prompts[0], max_new_tokens=12))
        e.submit(cls(1, prompts[1], max_new_tokens=12, deadline_s=wait))
        t0 = time.perf_counter()
        e.step()                        # admits both, decodes a horizon
        assert len(e._active) == 2
        time.sleep(max(0.0, wait - (time.perf_counter() - t0)) + 0.01)
        outs.append(e.run())
    out, jout = outs
    assert out[1].status == "deadline" and not out[1].complete
    assert out[1].tokens == jout[1].tokens and len(out[1].tokens) == 4
    assert "deadline_s exceeded" in out[1].error
    assert out[0].status == "ok" and out[0].tokens == _fault_free(
        qwen, [Request(0, prompts[0], max_new_tokens=12)],
        decode_horizon=4)[0]
    assert not eng._act.any() and not eng._inject.any()
    eng.pages.allocator.assert_drained()
    for c in COUNTERS:
        assert eng.metrics[c] == jeng.metrics[c], c


# --------------------------------------------------------- injected faults
def _static_buffers(eng):
    """Every static buffer a decode step or round reads or writes,
    cloned, and the pool tensors' addresses."""
    bufs = {n: getattr(eng, n).clone() for n in
            ("_tok", "_pos", "_act", "_rem", "_eos", "_floor", "_inject",
             "_t", "_hist")}
    bufs["table"] = eng.pages.table().clone()
    ptrs = {k: v.data_ptr() for k, v in eng.pages.cache.items()}
    return bufs, ptrs


@pytest.mark.parametrize("spec", [False, True], ids=["horizon", "spec"])
def test_injected_step_error_restores_donated_cache(qwen, spec):
    """``error@1`` raises out of ``run()`` inside the decode (or round's)
    call bracket; every static buffer and the pool are as the failed
    step found them, and a second ``run()`` completes every request
    with the fault-free tokens, as in the JAX engine (the reference's
    ``test_injected_step_error_spec_decode`` is the ``spec`` case)."""
    n, kw = (2, dict(spec_decode=True, draft_len=3)) if spec else \
        (3, dict(stream_sched=True))
    prompts = _prompts(n, seed=25 if spec else 24)
    eng, jeng = _pair(qwen, faults="error@1", **kw)
    _submit_both(eng, jeng, prompts, 6)
    eng.step()                     # step 0: admit and decode
    before, ptrs = _static_buffers(eng)
    captures = eng.metrics["graph_captures"]
    with pytest.raises(InjectedFault):
        eng.run()                  # step 1 raises
    with pytest.raises(jfaults.InjectedFault):
        jeng.run()
    assert not jeng.pages.donated
    after, ptrs_after = _static_buffers(eng)
    for name, x in before.items():
        assert torch.equal(x, after[name]), f"{name} changed by the unwind"
    assert ptrs_after == ptrs
    assert eng.metrics["graph_captures"] == captures
    out, jout = eng.run(), jeng.run()   # the engine stays fully usable
    ref = _fault_free(qwen, [Request(u, p, max_new_tokens=6)
                             for u, p in enumerate(prompts)], **kw)
    for uid in range(n):
        assert out[uid].complete and out[uid].tokens == ref[uid]
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)


def test_injected_pool_exhaustion_defers_not_fails(qwen):
    prompts = _prompts(4, seed=26)
    eng, jeng = _pair(qwen, faults="exhaust@0", stream_sched=True)
    _submit_both(eng, jeng, prompts, 5)
    out, jout = eng.run(), jeng.run()   # the scheduler defers and retries
    assert eng.metrics["faults_injected"] >= 1
    assert eng.metrics["sched_deferred"] >= 1
    ref = _fault_free(qwen, [Request(u, p, max_new_tokens=5)
                             for u, p in enumerate(prompts)])
    for uid in range(4):
        assert out[uid].complete and out[uid].tokens == ref[uid]
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)
    assert eng.sched.admitted_uids == jeng.sched.admitted_uids


def test_injected_pool_exhaustion_static_raises(qwen):
    """Static admission has no scheduler to defer: the injected
    ``PoolExhausted`` propagates, the request is requeued, and the next
    step admits it."""
    from repro.serving import PoolExhausted as JPoolExhausted
    from repro_torch.serving import PoolExhausted
    prompts = _prompts(2, seed=34)
    eng, jeng = _pair(qwen, faults="exhaust@0")
    _submit_both(eng, jeng, prompts, 4)
    for e, exc in ((eng, PoolExhausted), (jeng, JPoolExhausted)):
        with pytest.raises(exc, match="injected pool exhaustion"):
            e.step()
    out, jout = eng.run(), jeng.run()
    assert all(r.complete for r in out.values())
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)


@pytest.mark.parametrize("spec", [False, True], ids=["horizon4", "spec"])
def test_nan_tripwire_isolates_one_slot(qwen, spec):
    """``nan@1`` poisons one request's logits through the NaN mask: that
    request comes back ``status="error"``, its batchmates keep the
    fault-free tokens (the reference's ``test_nan_tripwire_spec_decode``
    is the ``spec`` case)."""
    if spec:
        n, victim, kw = 2, 0, dict(spec_decode=True, draft_len=3)
        prompts = _prompts(2, seed=28)
    else:
        n, victim, kw = 3, 1, dict(max_batch=3, stream_sched=True,
                                   decode_horizon=4)
        prompts = _prompts(3, seed=27)
    eng, jeng = _pair(qwen, faults=f"nan@1:uid={victim}", **kw)
    _submit_both(eng, jeng, prompts, 8)
    out, jout = eng.run(), jeng.run()
    assert out[victim].status == "error" and not out[victim].complete
    assert "non-finite" in out[victim].error
    assert eng.metrics["req_errors"] == 1
    assert eng.metrics["faults_injected"] == 1
    # acceptance accounting must not go negative on the faulted round
    assert eng.metrics["accepted_tokens"] >= 0
    ref = _fault_free(qwen, [Request(u, p, max_new_tokens=8)
                             for u, p in enumerate(prompts)], **kw)
    for uid in range(n):
        if uid != victim:          # batchmates keep their streams
            assert out[uid].status == "ok" and out[uid].tokens == ref[uid]
    assert not eng._inject.any()   # zeroed after the horizon's read
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)
