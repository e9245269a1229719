"""Port parity of the stream scheduler on reduced configs (CPU, plain
kernel versions).

The port of ``tests/test_scheduler.py``, test for test. Each test serves
its traffic through the port's ``Engine(stream_sched=True)`` and holds it
to the port's own static or solo engine, as the reference test does, and
runs the JAX engine on the same config, weights and traffic: the tokens,
the scheduler's admission order (``sched.admitted_uids``), each Result's
status, completeness and preemptions, and the scheduler's counters must
equal the reference's (``COUNTERS``; wall-clock fields are checked only
for sign). The JAX engine is pinned to the int8 pool and the XLA
backends, as in the port's other serving tests.

The traffic tests run the reference's seeded generator
(``benchmarks/traffic.py``, which drives any engine), hold the serve
CLI's Poisson rule (``launch/serve.poisson_arrivals``) to its arrival
steps, and replay one trace through both engines.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import traffic as jtraffic
from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import poisson_arrivals
from repro_torch.models import registry
from repro_torch.serving import (Engine, Request, SchedulerConfig,
                                 WatchdogError)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

#: the scheduler's and the lifecycle's counters, equal to the reference's
COUNTERS = ("sched_admitted", "sched_recycled", "sched_deferred",
            "sched_chunk_tokens", "sched_interleaved_steps", "watchdog_shed",
            "queue_rejected", "sched_preempted", "req_cancelled",
            "req_errors", "decode_steps", "tokens_out", "prefill_calls",
            "prefill_tokens")


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _dense(cfg):
    return cfg if cfg.hdp is None else cfg.replace(
        hdp=cfg.hdp.replace(enabled=False))


def _configs(arch, hdp_off=True):
    """(port config, JAX config) of ``arch`` reduced, HDP off as the
    reference's ``_qwen`` sets it."""
    cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    return (_dense(cfg), _dense(jcfg)) if hdp_off else (cfg, jcfg)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _weights(cfg):
    """Seeded weights as (JAX tree, port dict)."""
    tree = _numpy_tree(registry.init_params(cfg, 0, "cpu"))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def qwen():
    cfg, jcfg = _configs("qwen2-1.5b")
    return cfg, jcfg, _weights(cfg)


def _pair(setup, **kw):
    """The port's engine and the JAX engine on one config and weights."""
    cfg, jcfg, (jparams, params) = setup
    kw.setdefault("spec_decode", False)
    kw.setdefault("prefix_cache", False)
    eng = Engine(cfg, params, device="cpu", **kw)
    jeng = JEngine(jcfg, params=jparams,
                   attn=JSpec(backend="xla", kv_dtype="int8"), **kw)
    return eng, jeng


def _same_as_jax(eng, jeng, out, jout):
    """The port's serve equals the reference's: tokens, admission order,
    Result status, completeness and preemptions, counters; the timing
    fields have the reference's signs."""
    assert sorted(out) == sorted(jout)
    for u in jout:
        r, j = out[u], jout[u]
        assert r.tokens == j.tokens, f"req {u}: {r.tokens} != {j.tokens}"
        assert (r.status, r.complete, r.preemptions, r.prompt_len) == \
            (j.status, j.complete, j.preemptions, j.prompt_len), f"req {u}"
        for f in ("queue_wait_s", "ttft_s", "tpot_s"):
            a, b = getattr(r, f), getattr(j, f)
            assert (a is None) == (b is None), f"req {u}: {f} {a} vs {b}"
            assert a is None or a >= 0, f"req {u}: {f} {a}"
    if jeng.sched is not None:
        assert eng.sched.admitted_uids == jeng.sched.admitted_uids
    for c in COUNTERS:
        assert eng.metrics[c] == jeng.metrics[c], \
            f"{c}: port {eng.metrics[c]} vs JAX {jeng.metrics[c]}"


def _submit_all(eng, cls, prompts, max_new):
    for uid, p in enumerate(prompts):
        eng.submit(cls(uid, p, max_new_tokens=max_new))


def test_stream_equals_static_and_recycles(qwen):
    prompts = _prompts(6, seed=3)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    eng, jeng = _pair(qwen, stream_sched=True, **kw)
    _submit_all(eng, Request, prompts, 5)
    _submit_all(jeng, JRequest, prompts, 5)
    stream, jstream = eng.run(), jeng.run()

    static = Engine(qwen[0], qwen[2][1], device="cpu", **kw)
    _submit_all(static, Request, prompts, 5)
    ref = static.run()
    assert all(stream[u].tokens == ref[u].tokens for u in ref)
    # 6 requests through 2 slots: admissions past the first wave filled
    # slots vacated while the engine was already decoding
    assert eng.metrics["sched_recycled"] > 0
    assert eng.metrics["sched_admitted"] == 6
    assert all(stream[u].complete for u in stream)
    _same_as_jax(eng, jeng, stream, jstream)


def test_recycling_keeps_refcounts_clean(qwen):
    # prefix cache off: with it on, finished prompts keep pages referenced
    # from the radix tree, so in_use == 0 would not hold
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
              stream_sched=True, prefix_cache=False)
    eng, jeng = _pair(qwen, **kw)
    prompts = _prompts(5, seed=1)
    _submit_all(eng, Request, prompts, 3)
    _submit_all(jeng, JRequest, prompts, 3)
    out, jout = eng.run(), jeng.run()
    alloc = eng.pages.allocator
    # every slot retired: no page keeps an owner, the free list is whole
    # again, and no slot still holds a table row
    assert alloc.in_use == 0
    assert alloc.available == alloc.capacity
    assert all(not eng.pages.slot_pages(s) for s in range(eng.max_batch))
    assert not eng.pages.table().any()
    assert len(eng._free) == eng.max_batch
    assert not eng._act.any()
    _same_as_jax(eng, jeng, out, jout)


def test_token_budget_defers_until_pages_free(qwen):
    prompts = _prompts(3, lo=20, hi=21, seed=9)
    # 3 usable pages (page_size 16): each request needs 2, so only one
    # fits at a time; the second must defer, not crash admission
    eng, jeng = _pair(qwen, max_batch=2, max_len=64,
                      prefill_buckets=(16, 32), num_pages=4,
                      stream_sched=True)
    _submit_all(eng, Request, prompts, 6)
    _submit_all(jeng, JRequest, prompts, 6)
    out, jout = eng.run(), jeng.run()
    assert eng.metrics["sched_deferred"] > 0
    assert all(out[u].complete for u in out)
    for uid, p in enumerate(prompts):
        solo = Engine(qwen[0], qwen[2][1], device="cpu", max_batch=1,
                      max_len=64, prefill_buckets=(16, 32))
        solo.submit(Request(99, p, max_new_tokens=6))
        assert out[uid].tokens == solo.run()[99].tokens
    _same_as_jax(eng, jeng, out, jout)


def test_admission_orders_biggest_prefix_hit_first(qwen):
    rng = np.random.default_rng(17)
    base = rng.integers(1, 250, size=33).tolist()
    eng, jeng = _pair(qwen, max_batch=1, max_len=64,
                      prefill_buckets=(16, 32, 48), prefix_cache=True,
                      stream_sched=True)
    for e, cls in ((eng, Request), (jeng, JRequest)):
        e.submit(cls(0, base, max_new_tokens=3))
        e.run()   # registers base's first two pages in the radix tree

    cold_a = rng.integers(1, 250, size=12).tolist()
    hot = base[:32] + rng.integers(1, 250, size=6).tolist()
    cold_b = rng.integers(1, 250, size=12).tolist()
    for e, cls in ((eng, Request), (jeng, JRequest)):
        for uid, p in ((1, cold_a), (2, hot), (3, cold_b)):
            e.submit(cls(uid, p, max_new_tokens=3))
    out, jout = eng.run(), jeng.run()
    # the cached-prefix request jumps the FIFO; misses keep their order
    assert eng.sched.admitted_uids == [0, 2, 1, 3]
    assert eng.prefix.hits > 0
    assert (eng.prefix.hits, eng.prefix.misses) == \
        (jeng.prefix.hits, jeng.prefix.misses)
    assert all(out[u].complete for u in out)
    _same_as_jax(eng, jeng, out, jout)


def test_chunked_prefill_interleaves_with_decode(qwen):
    rng = np.random.default_rng(7)
    long_p = rng.integers(1, 250, size=80).tolist()
    shorts = _prompts(3, seed=11)
    # single-token steps: at horizon 4 (or with draft rounds) the 4-token
    # shorts finish inside one engine step, so no decode is live while a
    # chunk advances (composition is the everything-on test's)
    eng, jeng = _pair(qwen, max_batch=2, max_len=128,
                      prefill_buckets=(16, 32), stream_sched=True,
                      decode_horizon=1,
                      sched=SchedulerConfig(prefill_chunk_tokens=32))
    for e, cls in ((eng, Request), (jeng, JRequest)):
        e.submit(cls(0, long_p, max_new_tokens=4))
        for uid, p in enumerate(shorts, start=1):
            e.submit(cls(uid, p, max_new_tokens=4))
    out, jout = eng.run(), jeng.run()
    # the long prompt prefilled through per-step slices, some of which
    # ran while other slots were decoding
    assert eng.metrics["sched_chunk_tokens"] >= 80
    assert eng.metrics["sched_interleaved_steps"] > 0
    for uid, p in [(0, long_p)] + list(enumerate(shorts, start=1)):
        solo = Engine(qwen[0], qwen[2][1], device="cpu", max_batch=1,
                      max_len=128, prefill_buckets=(16, 32))
        solo.submit(Request(99, p, max_new_tokens=4))
        assert out[uid].tokens == solo.run()[99].tokens, f"req {uid}"
    _same_as_jax(eng, jeng, out, jout)


def _stuck(setup, **sched):
    """A request whose footprint (4 pages) the pool (2 usable) can never
    hold, on both engines."""
    eng, jeng = _pair(setup, max_batch=1, max_len=64,
                      prefill_buckets=(16, 32), num_pages=3,
                      stream_sched=True,
                      sched=SchedulerConfig(watchdog_steps=5, **sched))
    p = _prompts(1, lo=20, hi=21, seed=5)[0]
    eng.submit(Request(0, p, max_new_tokens=30))
    jeng.submit(JRequest(0, p, max_new_tokens=30))
    return eng, jeng


def test_watchdog_sheds_stuck_request(qwen):
    # no amount of waiting admits it: the watchdog sheds it as a typed
    # per-request failure instead of killing the serving loop
    eng, jeng = _stuck(qwen)
    out, jout = eng.run(), jeng.run()
    assert out[0].status == "error" and not out[0].complete
    assert "watchdog" in out[0].error
    assert eng.metrics["watchdog_shed"] == 1
    eng.pages.allocator.assert_drained()
    _same_as_jax(eng, jeng, out, jout)


def test_watchdog_escalation_zero_raises(qwen):
    # escalation 0: the loop-fatal WatchdogError on the first trip
    eng, jeng = _stuck(qwen, watchdog_escalation=0)
    with pytest.raises(WatchdogError, match=r"\[0\] pending"):
        eng.run()
    from repro.serving import WatchdogError as JWatchdogError
    with pytest.raises(JWatchdogError, match=r"\[0\] pending"):
        jeng.run()
    assert eng.sched._trips == jeng.sched._trips == 1
    assert eng.sched._idle_steps == jeng.sched._idle_steps == 5


def test_serve_generator_streams_in_completion_order(qwen):
    eng, jeng = _pair(qwen, max_batch=2, max_len=64,
                      prefill_buckets=(16, 32), stream_sched=True)
    prompts = _prompts(4, seed=13)
    seen = [r.uid for r in eng.serve(
        [Request(u, p, max_new_tokens=3 + u % 3)
         for u, p in enumerate(prompts)])]
    jseen = [r.uid for r in jeng.serve(
        [JRequest(u, p, max_new_tokens=3 + u % 3)
         for u, p in enumerate(prompts)])]
    assert sorted(seen) == [0, 1, 2, 3]
    assert seen == jseen
    assert all(eng.results()[u].complete for u in seen)
    s = eng.summary()
    assert s["ttft_s_mean"] > 0 and s["queue_wait_s_mean"] >= 0
    assert s["queue_depth_peak"] >= 1
    js = jeng.summary()
    assert s["queue_depth_peak"] == js["queue_depth_peak"]
    assert s["queue_depth_mean"] == js["queue_depth_mean"]
    assert s["tpot_s_mean"] > 0 and s["ttft_s_p95"] >= s["ttft_s_p50"] > 0
    _same_as_jax(eng, jeng, eng.results(), jeng.results())


def test_everything_on_composition_token_identity():
    # horizon + prefix cache + spec decode + stream scheduler, HDP on
    cfg, jcfg = _configs("granite-8b", hdp_off=False)
    assert cfg.hdp is not None and cfg.hdp.enabled
    setup = (cfg, jcfg, _weights(cfg))
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
              decode_horizon=4, prefix_cache=True, spec_decode=True)
    eng, jeng = _pair(setup, stream_sched=True, **kw)
    prompts = _prompts(5, seed=21)
    _submit_all(eng, Request, prompts, 5)
    _submit_all(jeng, JRequest, prompts, 5)
    stream, jstream = eng.run(), jeng.run()
    static = Engine(cfg, setup[2][1], device="cpu", **kw)
    _submit_all(static, Request, prompts, 5)
    ref = static.run()
    assert all(stream[u].tokens == ref[u].tokens for u in ref)
    assert eng.metrics["sched_recycled"] > 0
    _same_as_jax(eng, jeng, stream, jstream)
    for c in ("spec_rounds", "accepted_tokens", "cow_copies"):
        assert eng.metrics[c] == jeng.metrics[c], c


def _trace_key(trace):
    return [(r.uid, r.arrival_step, r.prompt, r.max_new_tokens)
            for r in trace]


def test_traffic_generator_is_deterministic():
    kw = dict(n_requests=12, rate=0.4, long_frac=0.25, seed=42)
    a, b = (jtraffic.generate(jtraffic.TrafficConfig(**kw))
            for _ in range(2))
    assert _trace_key(a) == _trace_key(b)
    # arrival steps are a non-decreasing Poisson cumsum, uids in order
    assert all(x.arrival_step <= y.arrival_step for x, y in zip(a, a[1:]))
    assert [r.uid for r in a] == list(range(12))
    # the serve CLI's Poisson rule gives the generator's arrival steps
    assert poisson_arrivals(np.random.default_rng(42), 0.4, 12).tolist() \
        == [r.arrival_step for r in a]
    # a different seed moves the trace
    c = jtraffic.generate(jtraffic.TrafficConfig(**{**kw, "seed": 43}))
    assert [r.prompt for r in c] != [r.prompt for r in a]


def test_traffic_burst_and_replay(qwen):
    kw = dict(n_requests=5, arrival="burst", prompt_lo=4, prompt_hi=12,
              max_new_lo=3, max_new_hi=4, seed=8)
    trace = jtraffic.generate(jtraffic.TrafficConfig(**kw))
    assert all(r.arrival_step == 0 for r in trace)
    eng, jeng = _pair(qwen, max_batch=2, max_len=64,
                      prefill_buckets=(16, 32), stream_sched=True)
    results, steps = jtraffic.replay(eng, trace, Request)
    jresults, jsteps = jtraffic.replay(jeng, trace, JRequest)
    assert sorted(results) == [0, 1, 2, 3, 4]
    assert all(results[u].complete for u in results)
    assert steps >= 3   # 5 requests through 2 slots: not one wave
    assert steps == jsteps
    _same_as_jax(eng, jeng, results, jresults)


def test_scheduler_config_validation():
    from repro.serving import SchedulerConfig as JSchedulerConfig
    for bad in (dict(order="lifo"), dict(watchdog_steps=0),
                dict(prefill_chunk_tokens=0), dict(watchdog_escalation=-1),
                dict(max_queue_depth=0), dict(preempt_after=0)):
        with pytest.raises(ValueError):
            SchedulerConfig(**bad)
        with pytest.raises(ValueError):
            JSchedulerConfig(**bad)
    assert SchedulerConfig() == SchedulerConfig(
        **{f: getattr(JSchedulerConfig(), f)
           for f in JSchedulerConfig.__dataclass_fields__})
    with pytest.raises(ValueError):
        jtraffic.TrafficConfig(arrival="weibull")
    with pytest.raises(ValueError):
        jtraffic.TrafficConfig(arrival="poisson", rate=0.0)
