"""Port parity of the request lifecycle on reduced qwen2-1.5b (CPU, plain
kernel versions).

The port of the tests of ``tests/test_faults.py`` that need no fault
injection: the transient-error taxonomy, cancelling a queued and an
active request, ``QueueFull`` backpressure, and preempt-and-restore
with the victim's tokens equal to an uninterrupted run. Each serve runs
on the port's engine and on the JAX engine (int8 pool, XLA backends) on
the same weights and traffic, and the tokens, Result fields, admission
order and counters must agree.

``test_transient_taxonomy_and_retry`` holds the port's classifier to
the reference's, ``InjectedFault`` included (hard by design: a retry
layer must not paper over an injected fault). Its retry half drives the
reference's ``training.fault.retry`` with the port's classifier, since
the port has no training package yet (item 11). The tests that inject
faults (``FaultPlan``, ``FaultInjector``) and expire deadlines are in
``test_torch_faults.py``, the ``ReplicaSet`` ones in
``test_torch_replica.py``.
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
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import is_transient as jax_is_transient
from repro.serving.faults import InjectedFault as JInjectedFault
from repro.training.fault import retry
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving import (Engine, InjectedFault, PoolExhausted,
                                 QueueFull, Request, SchedulerConfig,
                                 TransientError, is_transient)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

COUNTERS = ("sched_admitted", "sched_recycled", "sched_deferred",
            "sched_preempted", "req_cancelled", "req_errors",
            "queue_rejected", "watchdog_shed", "decode_steps", "tokens_out",
            "prefill_calls")


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


def _pair(setup, sched=None, jsched=None, **kw):
    cfg, jcfg, jparams, params = setup
    kw = {**dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
                 stream_sched=True, prefix_cache=False, spec_decode=False),
          **kw}
    eng = Engine(cfg, params, device="cpu", sched=sched, **kw)
    jeng = JEngine(jcfg, params=jparams, sched=jsched,
                   attn=JSpec(backend="xla", kv_dtype="int8"), **kw)
    return eng, jeng


def _solo_tokens(setup, reqs):
    """The reference stream: each request served alone on a fresh port
    engine."""
    cfg, _, _, params = setup
    out = {}
    for r in reqs:
        solo = Engine(cfg, params, device="cpu", max_batch=1, max_len=64,
                      prefill_buckets=(16, 32))
        solo.submit(Request(99, list(r.prompt),
                            max_new_tokens=r.max_new_tokens))
        out[r.uid] = solo.run()[99].tokens
    return out


def _same_as_jax(eng, jeng, out, jout):
    assert sorted(out) == sorted(jout)
    for u in jout:
        r, j = out[u], jout[u]
        assert r.tokens == j.tokens, f"req {u}: {r.tokens} != {j.tokens}"
        assert (r.status, r.complete, r.preemptions, r.prompt_len,
                r.decode_steps) == (j.status, j.complete, j.preemptions,
                                    j.prompt_len, j.decode_steps), f"req {u}"
        for f in ("queue_wait_s", "ttft_s", "tpot_s"):
            a, b = getattr(r, f), getattr(j, f)
            assert (a is None) == (b is None), f"req {u}: {f} {a} vs {b}"
            assert a is None or a >= 0, f"req {u}: {f} {a}"
    assert eng.sched.admitted_uids == jeng.sched.admitted_uids
    for c in COUNTERS:
        assert eng.metrics[c] == jeng.metrics[c], \
            f"{c}: port {eng.metrics[c]} vs JAX {jeng.metrics[c]}"


class _OldPoolExhausted(RuntimeError):
    """The port's PoolExhausted before it joined the taxonomy: a bare
    RuntimeError subclass."""


def test_pool_exhausted_is_transient():
    assert not is_transient(_OldPoolExhausted("pool"))
    assert not jax_is_transient(_OldPoolExhausted("pool"))
    assert issubclass(PoolExhausted, TransientError)
    assert issubclass(PoolExhausted, RuntimeError)   # callers catching it
    assert is_transient(PoolExhausted("pool"))


def test_transient_taxonomy_and_retry():
    cases = [TransientError("x"), PoolExhausted("pool"), OSError("io"),
             TimeoutError("t"), RuntimeError("collective timeout"),
             RuntimeError("Pool Exhausted"), RuntimeError("shape mismatch"),
             ValueError("bad"), QueueFull("typed backpressure")]
    want = [True, True, True, True, True, True, False, False, True]
    assert [is_transient(e) for e in cases] == want
    # the reference classifies the same messages and types alike
    assert [jax_is_transient(e) for e in cases[2:8]] == want[2:8]
    # an injected fault is hard by design, in both packages, whatever its
    # message says
    for msg in ("boom", "injected step failure (scheduled step 3)",
                "collective timeout"):
        assert not is_transient(InjectedFault(msg))
        assert not jax_is_transient(JInjectedFault(msg))
    assert issubclass(InjectedFault, RuntimeError)
    assert not issubclass(InjectedFault, TransientError)

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("try again")
        return "ok"

    assert retry(flaky, retries=3, backoff_s=0.0,
                 transient=is_transient) == "ok"
    assert len(calls) == 3

    def hard():
        calls.append(1)
        raise RuntimeError("assertion failed in kernel")

    calls.clear()
    with pytest.raises(RuntimeError, match="assertion"):
        retry(hard, retries=3, backoff_s=0.0, transient=is_transient)
    assert len(calls) == 1                # fail-fast: no retry burned

    def injected():
        calls.append(1)
        raise InjectedFault("injected step failure (scheduled step 0)")

    calls.clear()
    with pytest.raises(InjectedFault):
        retry(injected, retries=3, backoff_s=0.0, transient=is_transient)
    assert len(calls) == 1                # an injected fault is not retried


def test_cancel_queued_and_active(qwen):
    prompts = _prompts(4, seed=21)
    eng, jeng = _pair(qwen)
    for e, cls in ((eng, Request), (jeng, JRequest)):
        for uid, p in enumerate(prompts):
            e.submit(cls(uid, p, max_new_tokens=8))
        e.step()                   # activates uids 0 and 1
        assert e.cancel(0)         # active mid-decode
        assert e.cancel(3)         # still waiting in the scheduler
        assert not e.cancel(17)    # unknown uid
    # the cancelled slot is parked on the device at once: only uid 1's
    # slot is still armed
    assert int(eng._act.sum()) == 1
    out, jout = eng.run(), jeng.run()
    for uid in (0, 3):
        assert out[uid].status == "cancelled" and not out[uid].complete
    ref = _solo_tokens(qwen, [Request(u, prompts[u], max_new_tokens=8)
                              for u in (1, 2)])
    for uid in (1, 2):             # batchmates unaffected
        assert out[uid].status == "ok"
        assert out[uid].tokens == ref[uid]
    assert eng.metrics["req_cancelled"] == 2
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)


def test_submit_backpressure_queue_full(qwen):
    from repro.serving import QueueFull as JQueueFull
    prompts = _prompts(4, seed=23)
    eng, jeng = _pair(qwen, max_batch=1,
                      sched=SchedulerConfig(max_queue_depth=2),
                      jsched=JSchedulerConfig(max_queue_depth=2))
    for e, cls, exc in ((eng, Request, QueueFull),
                        (jeng, JRequest, JQueueFull)):
        for uid in range(2):
            e.submit(cls(uid, prompts[uid], max_new_tokens=4))
        with pytest.raises(exc, match="max_queue_depth=2"):
            e.submit(cls(2, prompts[2], max_new_tokens=4))
    assert is_transient(QueueFull("typed backpressure is retryable"))
    assert eng.metrics["queue_rejected"] == 1
    out, jout = eng.run(), jeng.run()       # the rejected request left no trace
    assert sorted(out) == [0, 1] and all(out[u].complete for u in out)
    _same_as_jax(eng, jeng, out, jout)


def test_preempt_and_restore_byte_identical(qwen):
    prompts = _prompts(3, lo=12, hi=20, seed=29)
    eng, jeng = _pair(
        qwen, sched=SchedulerConfig(preempt_after=2, watchdog_steps=60),
        jsched=JSchedulerConfig(preempt_after=2, watchdog_steps=60))
    for e, cls in ((eng, Request), (jeng, JRequest)):
        # two long low-priority requests fill both slots...
        e.submit(cls(0, prompts[0], max_new_tokens=24))
        e.submit(cls(1, prompts[1], max_new_tokens=24))
        for _ in range(3):
            e.step()
        # ...then a high-priority arrival must preempt one of them
        e.submit(cls(2, prompts[2], max_new_tokens=4, priority=1))
    out, jout = eng.run(), jeng.run()
    assert eng.metrics["sched_preempted"] >= 1
    preempted = [u for u in out if out[u].preemptions >= 1]
    assert preempted
    ref = _solo_tokens(qwen, [Request(u, prompts[u],
                                      max_new_tokens=24 if u < 2 else 4)
                              for u in range(3)])
    for uid in range(3):           # the preempted victim included
        assert out[uid].complete and out[uid].tokens == ref[uid], f"req {uid}"
        assert out[uid].prompt_len == len(prompts[uid])
    eng.pages.allocator.assert_drained()
    assert not eng._act.any() and not eng.pages.table().any()
    _same_as_jax(eng, jeng, out, jout)

