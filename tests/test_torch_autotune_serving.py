"""Port parity of cost-policy serving and acceptance-adaptive speculation
on reduced qwen2-1.5b (CPU, plain kernel versions, int8 paged pool).

The port of ``TestEngineCostPolicy`` and ``TestAdaptiveSpec`` of
``tests/test_autotune.py``, each against the JAX engine on the same
weights and traffic (one JAX engine per mode, each drained once and
reused where a test needs several of its serves):

* cost-policy tokens equal the JAX engine's cost-policy and static
  tokens; ``attn_policy``, every ``resolved_backend`` phase (prefill,
  decode, draft, verify), the tuner's decisions, pending probes and
  ``probes`` equal the reference's (``hits``/``misses`` count
  consultations, which the port makes per dispatch and the reference per
  trace, so they are not compared);
* a forced flip every step still gives the reference's tokens with
  ``_attn_epoch > 0``, and a flip drops the captured graphs: one
  re-capture per flip;
* adaptive rounds equal greedy decode, and ``spec_ctl.summary()`` equals
  the JAX engine's; both forced schedules of the reference give greedy
  tokens and the reference's summaries, and capture one graph per
  (k, tier);
* ``adaptive_spec=True`` without spec decode raises; the scheduler's
  recycle hook flushes the tuner.
"""
from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.attention.registry as jregistry
import repro.autotune as jat
from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.roofline.hardware import HOST_CPU as J_CPU
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import AttnSpec
from repro_torch.autotune import (SpecController, Tuner, default_tuner,
                                  reset_default_tuner)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.roofline.hardware import H100_SXM, HOST_CPU
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
          prefix_cache=False, stream_sched=False)
MAX_NEW = 8
SCHEDULES = {
    "off": [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],    # speculation forced off
    "thrash": [4, 1, 2, 4, 1, 3, 2, 1, 4, 2],  # thrashing k + profiles
}
PHASES = ("prefill", "decode", "draft", "verify")


def _prompts(n, lo=4, hi=20, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


#: prompts of at most 16 tokens: one prefill bucket, so each JAX engine
#: compiles one prefill
PROMPTS = _prompts(3, hi=16, seed=5)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _run(eng, req_cls=Request, prompts=PROMPTS, max_new=MAX_NEW):
    for uid, p in enumerate(prompts):
        eng.submit(req_cls(uid, p, max_new_tokens=max_new))
    return {uid: r.tokens for uid, r in eng.run().items()}


class _ForcedCtl:
    """SpecController stand-in replaying a fixed (k, profile) schedule
    (the reference test's)."""

    def __init__(self, ctl, ks):
        self._ctl = ctl
        self._ks = list(ks)
        self.plans = []

    def plan(self):
        k = self._ks.pop(0) if self._ks else 1
        tier = {1: self._ctl.conservative, 2: self._ctl.base}
        profile = tier.get(k, self._ctl.aggressive)
        self.plans.append(k)
        return k, profile

    def update(self, accepted, drafted):
        self._ctl.update(accepted, drafted)

    def summary(self):
        return self._ctl.summary()


class _EagerGraph:
    """Stands in for a captured CUDA graph: replay runs the body."""

    def __init__(self, body):
        self.replay = body


def _stub_capture(eng, keys):
    """Make a CPU engine take its graphed path: each capture records the
    key of the graph it makes (read from the engine's ``_run`` call)
    and returns a stand-in graph that runs the body eagerly."""
    eng.cuda_graph = True
    run = eng._run

    def tracking_run(key, body, width):
        if key not in eng._graphs:
            keys.append(key)
        return run(key, body, width)

    eng._run = tracking_run
    eng._capture = lambda body, width: (
        _EagerGraph(body), {"fum_kernel_launches": 0,
                            "block_kernel_launches": 0})


@pytest.fixture(autouse=True)
def _fresh_default_tuner(monkeypatch):
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_ATTN_POLICY", raising=False)
    monkeypatch.delenv("REPRO_ADAPTIVE_SPEC", raising=False)
    reset_default_tuner()
    jat.reset_default_tuner()
    yield
    reset_default_tuner()
    jat.reset_default_tuner()


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-1.5b"))
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    tree = _numpy_tree(registry.init_params(cfg, 0, "cpu"))
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The reference's serves, each engine drained once: static greedy
    tokens; the cost policy's tokens, tuner and resolved phases (a
    speculating engine, so the draft and verify calls are priced too);
    adaptive speculation, natural and under both forced schedules on
    one reused engine."""
    _, jcfg, jparams, _ = setup
    out = {}
    st = JEngine(jcfg, params=jparams, attn=JSpec(policy="static"),
                 spec_decode=False, **KW)
    out["static"] = _run(st, JRequest)
    out["static_phases"] = {p: st.resolved_backend(p)
                            for p in ("prefill", "decode")}
    for spec in (False, True):
        tuner = jat.Tuner(hw=J_CPU)
        co = JEngine(jcfg, params=jparams, attn=JSpec(policy="cost"),
                     tuner=tuner, spec_decode=spec, draft_len=4, **KW)
        tok = _run(co, JRequest)
        # a phase no dispatch decided reports the static order, which
        # the port takes from the reference's TPU rank
        with mock.patch.object(jregistry, "_on_tpu", lambda: True):
            phases = {p: co.resolved_backend(p)
                      for p in (PHASES if spec else PHASES[:2])}
        out[("cost", spec)] = dict(
            tokens=tok, summary=co.summary(), decision=dict(tuner.decision),
            pending=set(tuner.pending), measured=dict(tuner.measured),
            probes=tuner.probes, phases=phases)
        jat.reset_default_tuner()
    ad = JEngine(jcfg, params=jparams, spec_decode=True, draft_len=4,
                 adaptive_spec=True, **KW)
    ctl0 = ad.spec_ctl
    out["adaptive"] = (_run(ad, JRequest), ad.spec_ctl.summary(),
                       ad.summary()["spec_plans"])
    for name, ks in SCHEDULES.items():
        fresh = jat.SpecController(ctl0.base, jcfg.hdp, ctl0.cfg)
        forced = _ForcedCtl(fresh, ks)
        ad.spec_ctl = forced
        out[name] = (_run(ad, JRequest), fresh.summary(), forced.plans)
    return out


# ------------------------------------------------------------ cost policy
@pytest.mark.parametrize("spec", [False, True], ids=["greedy", "spec"])
def test_cost_policy_token_identity_and_summary(setup, jax_runs, spec):
    cfg, _, _, params = setup
    st = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="static"),
                spec_decode=False, **KW)
    assert _run(st) == jax_runs["static"]
    tuner = Tuner(hw=HOST_CPU)
    co = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="cost"),
                tuner=tuner, spec_decode=spec, draft_len=4, **KW)
    want = jax_runs[("cost", spec)]
    tok = _run(co)
    assert tok == want["tokens"] == jax_runs["static"]
    s = co.summary()
    assert s["attn_policy"] == want["summary"]["attn_policy"] == "cost"
    assert {"tuner_hits", "tuner_misses", "tuner_probes",
            "tuner_cached"} <= set(s)
    assert s["meas_decode_step_s"] > 0 and s["pred_decode_step_s"] > 0
    assert s["tuner_probes"] == want["summary"]["tuner_probes"]
    assert s["tuner_cached"] == want["summary"]["tuner_cached"]
    for p, name in want["phases"].items():
        assert co.resolved_backend(p) == name, p
    assert tuner.decision == want["decision"]
    assert set(tuner.pending) == want["pending"]
    assert tuner.measured == want["measured"]
    assert tuner.probes == want["probes"]
    assert st.summary()["attn_policy"] == "static"
    # before any cost decision the static (TPU-rank) order is reported;
    # the reference on the CPU ranks by its CPU order
    assert st.resolved_backend("decode") == "pallas_paged_decode"
    assert jax_runs["static_phases"]["decode"] == "paged_hdp_decode"


def test_probe_flip_bumps_epoch_not_tokens(setup, jax_runs):
    cfg, _, _, params = setup
    co = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="cost"),
                tuner=Tuner(hw=HOST_CPU), spec_decode=False, **KW)
    # force "a probe flipped something" every flush: each step re-consults
    # the tuner (epoch bump) and still commits identical tokens
    co.tuner.flush_probes = lambda: True
    assert _run(co) == jax_runs["static"]
    assert co._attn_epoch > 0


def test_flip_drops_graphs_and_recaptures(setup, jax_runs):
    """On the graphed path a flip drops every captured graph, so the next
    decode re-captures: captures == 1 + flips, tokens unchanged."""
    cfg, _, _, params = setup
    co = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="cost"),
                tuner=Tuner(hw=HOST_CPU), spec_decode=False, **KW)
    keys = []
    _stub_capture(co, keys)
    flushes = []

    def flip_at_third():
        flushes.append(1)
        return len(flushes) in (3, 5)

    co.tuner.flush_probes = flip_at_third
    assert _run(co) == jax_runs["static"]
    assert co._attn_epoch == 2 and keys == ["decode"] * 3
    assert co.summary()["graph_captures"] == 0   # stand-in captures
    assert list(co._graphs) == ["decode"]


def test_real_probes_in_an_engine(setup, jax_runs):
    """With every signature ambiguous the engine probes each pending
    signature at the top of the next step (on the CPU, through the
    plain versions), then serves from the measured cache: the tokens
    stay the reference's, nothing stays pending, and a warm start from
    the saved cache probes nothing."""
    cfg, _, _, params = setup
    tuner = Tuner(hw=HOST_CPU, margin=1e9, probe_reps=1)
    co = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="cost"),
                tuner=tuner, spec_decode=False, **KW)
    tok = _run(co)
    assert tok == jax_runs["static"]
    assert tuner.probes == len(tuner.measured) == len(tuner.probe_times) > 0
    assert not tuner.pending and tuner.hits > 0
    assert set(tuner.measured) == set(tuner.decision)


def test_explicit_tuner_is_installed(setup):
    cfg, _, _, params = setup
    mine = Tuner(hw=HOST_CPU)
    eng = Engine(cfg, params, device="cpu", max_batch=1, max_len=64,
                 prefill_buckets=(16,), attn=AttnSpec(policy="cost"),
                 tuner=mine)
    assert eng.tuner is mine and default_tuner() is mine
    # a CPU engine never prices with a card's profile
    with pytest.raises(ValueError, match="host_cpu"):
        Engine(cfg, params, device="cpu", max_batch=1, max_len=64,
               prefill_buckets=(16,), attn=AttnSpec(policy="cost"),
               tuner=Tuner(hw=H100_SXM))
    reset_default_tuner()
    eng = Engine(cfg, params, device="cpu", max_batch=1, max_len=64,
                 prefill_buckets=(16,), attn=AttnSpec(policy="cost"))
    assert eng.tuner.hw is HOST_CPU


def test_scheduler_recycle_flushes_the_tuner(setup, jax_runs):
    cfg, _, _, params = setup
    co = Engine(cfg, params, device="cpu", attn=AttnSpec(policy="cost"),
                tuner=Tuner(hw=HOST_CPU), spec_decode=False,
                **{**KW, "stream_sched": True})
    calls = []
    flush = co.tuner.flush_probes
    co.tuner.flush_probes = lambda: calls.append(1) or flush()
    steps = []
    step = co.step
    co.step = lambda: steps.append(1) or step()
    assert _run(co) == jax_runs["static"]
    s = co.summary()
    assert s["sched_recycled"] > 0
    assert len(calls) == len(steps) + s["sched_recycled"]


# ------------------------------------------------------ adaptive speculation
def test_requires_spec_decode(setup, monkeypatch):
    cfg, _, _, params = setup
    with pytest.raises(ValueError, match="adaptive_spec"):
        Engine(cfg, params, device="cpu", spec_decode=False,
               adaptive_spec=True)
    # the env default degrades silently without spec decode
    monkeypatch.setenv("REPRO_ADAPTIVE_SPEC", "1")
    assert Engine(cfg, params, device="cpu", spec_decode=False,
                  **KW).spec_ctl is None
    assert Engine(cfg, params, device="cpu", spec_decode=True,
                  **KW).spec_ctl is not None


def test_adaptive_rounds_token_identical_to_greedy(setup, jax_runs):
    cfg, _, _, params = setup
    ad = Engine(cfg, params, device="cpu", spec_decode=True, draft_len=4,
                adaptive_spec=True, **KW)
    keys = []
    _stub_capture(ad, keys)
    tok, summary, plans = jax_runs["adaptive"]
    assert _run(ad) == tok == jax_runs["static"]
    sc = ad.spec_ctl.summary()
    assert sc == summary
    assert sc["rounds"] > 0 and sc["draft_len_mean"] >= 1.0
    s = ad.summary()
    assert s["adaptive_spec"] and s["spec_plans"] == plans
    assert s["acceptance_ema"] == sc["acceptance_ema"]
    assert s["draft_len_mean"] == sc["draft_len_mean"]
    # one graph per (k, tier) that ran, never captured twice
    assert len(keys) == len(set(keys)) == s["spec_graphs"] <= 1 + 3 * 3
    assert set(keys) == set(ad._graphs)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_forced_schedule_token_identity(setup, jax_runs, schedule):
    cfg, _, _, params = setup
    ad = Engine(cfg, params, device="cpu", spec_decode=True, draft_len=4,
                adaptive_spec=True, **KW)
    keys = []
    _stub_capture(ad, keys)
    fresh = SpecController(ad.spec_ctl.base, cfg.hdp, ad.spec_ctl.cfg)
    forced = _ForcedCtl(fresh, SCHEDULES[schedule])
    ad.spec_ctl = forced
    tok, summary, plans = jax_runs[schedule]
    assert _run(ad) == tok == jax_runs["static"]
    assert forced.plans == plans
    assert forced.plans[:3] == SCHEDULES[schedule][:3]
    assert fresh.summary() == summary
    # each (k, tier) captured once; k = 1 has no tier. The plan runs 4
    # and 3 aggressive, 2 base (a width the budget clamps keeps its tier)
    assert len(keys) == len(set(keys)) == len(ad._graphs)
    if schedule == "off":
        assert set(keys) == {(1, None)}
    else:
        assert {(4, "aggressive"), (1, None), (2, "base")} <= set(keys) \
            <= {(1, None), (2, "base"), (2, "aggressive"),
                (3, "aggressive"), (4, "aggressive")}
