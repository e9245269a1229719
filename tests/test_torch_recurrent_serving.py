"""Port parity of serving the recurrent families on their reduced
configs (fp32, CPU): the port's ``Engine`` and the JAX ``Engine`` serve
the same prompts with the same weights from the dense slot layout. This
file holds rwkv6-3b and what both families share; zamba2-7b's JAX
engine runs in ``test_torch_zamba2_serving.py`` (each file stays under
30 s on one worker).

* the reference's ``test_batched_equals_solo`` (``tests/test_serving.py``)
  for rwkv6-3b (HDP off, as there): every request of a batched serve
  equals its solo serve, and the port's tokens equal the JAX engine's,
  at decode horizons 1 and 4;
* exact-length prefill (rwkv6 and zamba2): one prefill call per distinct
  prompt length (a prompt past the largest bucket too, never chunked),
  rows of one length sharing a call, each request's tokens those of its
  solo serve;
* ``summary()``'s layout, pool format and resolved backends equal the
  JAX engine's ("none": rwkv6 has no attention);
* the decode graph's warm-up (``Engine._parked``: every slot parked, a
  recurrent state leaf saved and restored whole) leaves a serve's
  tokens as they were, at the first capture and at a re-capture
  mid-serve (after a tuner flip drops the graphs), on both families;
* the reference's ``test_spec_env_degrades_for_recurrent_families``;
* the stream scheduler gives the static engine's tokens on rwkv6, also
  when a high-priority arrival preempts a request (resumed by
  recompute, as in the reference).

One drained JAX engine per config serves every reference run (a JAX
engine compiles its jits per instance).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import registry
from repro_torch.serving import Engine, Request, SchedulerConfig

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ARCHS = ("rwkv6-3b", "zamba2-7b")
KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _dense(cfg):
    return cfg if cfg.hdp is None else cfg.replace(
        hdp=cfg.hdp.replace(enabled=False))


def _cfgs(arch, hdp=False):
    cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    return (cfg, jcfg) if hdp else (_dense(cfg), _dense(jcfg))


def _run(eng, R, prompts, max_new=5):
    for uid, p in enumerate(prompts):
        eng.submit(R(uid, p, max_new_tokens=max_new))
    return {u: r.tokens for u, r in eng.run().items()}


def _jax_tree(tree):
    """The port's parameter dict as the reference's tree of jax arrays
    (the same layout), so the JAX engine skips its own initialisation."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


_REF = {}


def _reference(arch):
    """The JAX engine (drained after one batched serve of the reference
    test's prompts) on seeded weights, its tokens, and the weights as
    the port holds them."""
    if arch not in _REF:
        cfg, jcfg = _cfgs(arch)
        params = registry.init_params(cfg, 0, "cpu")
        jeng = JEngine(jcfg, params=_jax_tree(params), **KW)
        tokens = _run(jeng, JRequest, _prompts(4, seed=3))
        _REF[arch] = (jeng, tokens, params)
    return _REF[arch]


def _batched_equals_solo(arch, horizon):
    cfg, _ = _cfgs(arch)
    jeng, jtok, params = _reference(arch)
    prompts = _prompts(4, seed=3)
    eng = Engine(cfg, params, device="cpu", decode_horizon=horizon, **KW)
    batched = _run(eng, Request, prompts)
    assert batched == jtok
    for uid, p in enumerate(prompts):
        solo = Engine(cfg, params, device="cpu", max_batch=1, max_len=64,
                      prefill_buckets=(16, 32), decode_horizon=horizon)
        solo.submit(Request(99, p, max_new_tokens=5))
        ref = solo.run()[99].tokens
        assert batched[uid] == ref, \
            f"{arch} req {uid}: batched {batched[uid]} != solo {ref}"


@pytest.mark.parametrize("horizon", [1, 4])
def test_batched_equals_solo(horizon):
    _batched_equals_solo("rwkv6-3b", horizon)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_length_prefill_groups(arch, monkeypatch):
    """Lengths 5, 9, 5, 40 (past the largest bucket, 32) and 9 admitted
    at once: one call of two rows per shared length and one of one row
    at 40, no padding and no chunk; each request's tokens are its solo
    serve's."""
    cfg = _dense(reduced(get_config(arch)))
    params = registry.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 250, size=n).tolist()
               for n in (5, 9, 5, 40, 9)]
    calls = []
    prefill = registry.apply_prefill

    def spy(cfg, params, batch, cache, **kw):
        calls.append(tuple(batch["tokens"].shape))
        return prefill(cfg, params, batch, cache, **kw)

    monkeypatch.setattr(registry, "apply_prefill", spy)
    eng = Engine(cfg, params, device="cpu", **{**KW, "max_batch": 5})
    tok = _run(eng, Request, prompts, max_new=4)
    assert sorted(calls) == [(1, 40), (2, 5), (2, 9)]
    assert eng.metrics["prefill_tokens"] == sum(map(len, prompts))
    for uid, p in enumerate(prompts):
        solo = Engine(cfg, params, device="cpu", **{**KW, "max_batch": 1})
        solo.submit(Request(uid, p, max_new_tokens=4))
        assert solo.run()[uid].tokens == tok[uid], uid


def _summary_equals_jax(arch):
    """After the batched serve (HDP off), and for engines built with HDP
    on (zamba2's shared block then resolves xla_hdp in both)."""
    cfg, _ = _cfgs(arch)
    jeng, _, params = _reference(arch)
    eng = Engine(cfg, params, device="cpu", **KW)
    _run(eng, Request, _prompts(4, seed=3))
    js, ts = jeng.summary(), eng.summary()
    assert ts["layout"] == js["cache_backend"] == "dense"
    assert ts["kv_dtype"] == js["kv_dtype"]
    for key in ("attn_backend_prefill", "attn_backend_decode",
                "spec_decode"):
        assert ts[key] == js[key], key
    assert "pred_decode_step_s" not in ts
    hcfg, hjcfg = _cfgs(arch, hdp=True)
    heng = Engine(hcfg, params, device="cpu", **KW)
    hjeng = JEngine(hjcfg, params=jeng.params, **KW)
    for phase in ("prefill", "decode"):
        assert heng.resolved_backend(phase) == \
            hjeng.resolved_backend(phase), phase
    want = "none" if arch == "rwkv6-3b" else "xla_hdp"
    assert heng.resolved_backend("decode") == want


def test_summary_layout_and_backends_equal_jax():
    _summary_equals_jax("rwkv6-3b")


class _EagerGraph:
    """Stands in for a captured CUDA graph: replay runs the body."""

    def __init__(self, body):
        self.replay = body


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_warmup_restores_recurrent_state(arch, horizon):
    """A CPU engine on its graphed path: each capture runs the real
    warm-up (a decode step with every slot parked, inside ``_parked``)
    and returns a stand-in graph; after two steps the graphs are dropped,
    as a tuner flip drops them, so the next step warms up and captures
    again with requests mid-decode. The tokens equal the eager serve's
    (which equal the JAX engine's), one capture per graph."""
    cfg = _dense(reduced(get_config(arch)))
    params = registry.init_params(cfg, 0, "cpu")
    prompts = _prompts(4, seed=3)
    eager = _run(Engine(cfg, params, device="cpu", decode_horizon=horizon,
                        **KW), Request, prompts)
    eng = Engine(cfg, params, device="cpu", decode_horizon=horizon, **KW)
    captures = []

    def capture(body, width):
        with eng._parked(width):
            body()                       # the warm-up step
        captures.append(width)
        return _EagerGraph(body), {"fum_kernel_launches": 0,
                                   "block_kernel_launches": 0}

    eng.cuda_graph, eng._capture = True, capture
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=5))
    eng.step()
    eng.step()
    eng._graphs.clear()                  # a flip: re-capture mid-serve
    out = {u: r.tokens for u, r in eng.run().items()}
    assert out == eager
    assert captures == [1, 1]


def test_spec_env_degrades_for_recurrent_families(monkeypatch):
    cfg = reduced(get_config("rwkv6-3b"))
    jcfg = jax_reduced(jax_get_config("rwkv6-3b"))
    _, _, params = _reference("rwkv6-3b")
    monkeypatch.setenv("REPRO_SPEC_DECODE", "1")
    assert not Engine(cfg, params, device="cpu", max_batch=1,
                      max_len=32).spec                # env degrades
    with pytest.raises(ValueError, match="spec_decode"):
        Engine(cfg, params, device="cpu", max_batch=1, max_len=32,
               spec_decode=True)                      # explicit raises
    jparams = _reference("rwkv6-3b")[0].params
    assert not JEngine(jcfg, params=jparams, max_batch=1, max_len=32).spec
    with pytest.raises(ValueError, match="spec_decode"):
        JEngine(jcfg, params=jparams, max_batch=1, max_len=32,
                spec_decode=True)


def _preempt_serve(eng, R):
    """Two long low-priority requests fill both slots; after three steps
    a high-priority arrival preempts one of them."""
    long = _prompts(3, lo=12, hi=20, seed=29)
    eng.submit(R(0, long[0], max_new_tokens=24))
    eng.submit(R(1, long[1], max_new_tokens=24))
    for _ in range(3):
        eng.step()
    eng.submit(R(2, long[2], max_new_tokens=4, priority=1))
    return long, eng.run()


def test_stream_sched_equals_static_rwkv6():
    """Five requests through two slots: stream == static == JAX. Then a
    preemption: the victim resumes by recompute (its generated tokens
    folded into the prompt, prefilled at exact length), as in the
    reference, whose tokens the port gives for every request. A
    recurrent victim parts from its uninterrupted run after the resume
    (the decode's first step replays the last prompt token into the
    state, so the resumed state holds another sequence; ROADMAP.md
    section 3); requests never preempted, and the victim up to its
    preemption, equal the uninterrupted run."""
    cfg, jcfg = _cfgs("rwkv6-3b")
    jeng, jtok, params = _reference("rwkv6-3b")
    prompts = _prompts(4, seed=3)
    eng = Engine(cfg, params, device="cpu", stream_sched=True, **KW)
    assert _run(eng, Request, prompts) == jtok
    assert eng.summary()["stream_sched"]

    sc = dict(preempt_after=2, watchdog_steps=60)
    eng = Engine(cfg, params, device="cpu", sched=SchedulerConfig(**sc),
                 **KW)
    long, out = _preempt_serve(eng, Request)
    jeng = JEngine(jcfg, params=jeng.params, sched=JSchedulerConfig(**sc),
                   **KW)
    _, jout = _preempt_serve(jeng, JRequest)
    assert eng.metrics["sched_preempted"] == \
        jeng.metrics["sched_preempted"] >= 1
    for uid in range(3):
        assert out[uid].complete and out[uid].tokens == jout[uid].tokens
        assert out[uid].preemptions == jout[uid].preemptions
        assert out[uid].prompt_len == len(long[uid])
        solo = Engine(cfg, params, device="cpu", **KW)
        solo.submit(Request(uid, long[uid],
                            max_new_tokens=24 if uid < 2 else 4))
        want = solo.run()[uid].tokens
        if not out[uid].preemptions:
            assert out[uid].tokens == want, f"req {uid}"
        else:
            assert out[uid].tokens[:3] == want[:3], f"req {uid}"
