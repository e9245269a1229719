"""Port parity of the fused decode horizon on reduced qwen2-1.5b (CPU,
plain kernel versions).

The port of ``tests/test_decode_hotpath.py``'s horizon tests, plus:

* the port at horizons 1, 3, 4 and 8, with staggered budgets (slots
  finish mid-horizon while their neighbours decode on), gives the tokens
  of its own horizon 1, and the tokens, ``decode_steps`` and
  ``tokens_out`` of the JAX ``Engine`` at the same horizon on the same
  weights (the JAX engine pinned to the int8 pool and the XLA backends);
* EOS firing mid-horizon gives horizon 1's tokens;
* one horizon is one host read, and ``_decode_body`` reads nothing back
  to the host (what lets a CUDA graph hold it): it runs under a dispatch
  mode that raises on scalar reads, ``nonzero`` and tensors made from
  host data, on every decode route (each pool format and the absmax
  scales, the block kernel, the dense layout, HDP off);
* a replayed step counts the launches recorded into it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro.attention import AttnSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import AttnSpec as TAttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.models import attention, registry
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
HORIZONS = (1, 3, 4, 8)


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


PROMPTS = _prompts(4, seed=3)


def _budget(uid: int) -> int:
    return 5 + uid % 3           # staggered: slots finish mid-horizon


def _cfg():
    return reduced(get_config("qwen2-1.5b"))


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def weights():
    """One set of seeded weights as the JAX tree and, through
    ``params_from_jax``, the port's dict (the two lay leaves out alike)."""
    tree = _numpy_tree(registry.init_params(_cfg(), 0, "cpu"))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(_cfg(), tree, "cpu"))


def _serve(params, horizon, prompts=PROMPTS, eos=None, **kw):
    eng = Engine(_cfg(), params, device="cpu", decode_horizon=horizon,
                 **{**KW, **kw})
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=_budget(uid), eos_id=eos))
    return eng, {u: r.tokens for u, r in eng.run().items()}


@pytest.fixture(scope="module")
def h1(weights):
    return _serve(weights[1], 1)[1]


@pytest.mark.parametrize("horizon", HORIZONS[1:])
def test_horizon_matches_single_step(weights, h1, horizon):
    eng, toks = _serve(weights[1], horizon)
    assert toks == h1, f"horizon={horizon}: {toks} != {h1}"
    assert all(len(toks[u]) == _budget(u) for u in toks)
    eng.pages.allocator.assert_drained()
    assert not eng._act.any() and sorted(eng._free) == [0, 1]


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine's tokens and metrics at each horizon. One engine
    serves every horizon in turn (its ``horizon`` is all that its
    ``decode_horizon`` argument sets), so its prefill and decode
    compilations are shared."""
    jeng = JEngine(jax_reduced(jax_get_config("qwen2-1.5b")),
                   params=weights[0],
                   attn=AttnSpec(backend="xla", kv_dtype="int8"),
                   decode_horizon=1, prefix_cache=False, spec_decode=False,
                   stream_sched=False, **KW)
    runs = {}
    for horizon in HORIZONS:
        jeng.horizon = horizon
        jeng.reset_metrics()
        for uid, p in enumerate(PROMPTS):
            jeng.submit(JRequest(uid, p, max_new_tokens=_budget(uid)))
        runs[horizon] = ({u: r.tokens for u, r in jeng.run().items()},
                         dict(jeng.metrics))
    return runs


@pytest.mark.parametrize("horizon", HORIZONS)
def test_horizon_matches_jax_engine(weights, h1, jax_runs, horizon):
    jtok, jmetrics = jax_runs[horizon]
    eng, tok = _serve(weights[1], horizon)
    assert tok == jtok == h1
    for key in ("decode_steps", "tokens_out", "prefill_calls",
                "prefill_tokens"):
        assert eng.metrics[key] == jmetrics[key], key


def test_eos_mid_horizon_matches_single_step(weights):
    params = weights[1]
    prompt = _prompts(1, seed=2)[0]
    eng = Engine(_cfg(), params, device="cpu", max_batch=1, max_len=64,
                 decode_horizon=1)
    eng.submit(Request(0, prompt, max_new_tokens=8))
    ref = eng.run()[0].tokens
    j = next((i for i in range(1, len(ref)) if ref[i] not in ref[:i]), None)
    assert j is not None, f"degenerate generation {ref}"
    for horizon in (1, 4, 8):
        e2 = Engine(_cfg(), params, device="cpu", max_batch=1, max_len=64,
                    decode_horizon=horizon)
        e2.submit(Request(0, prompt, max_new_tokens=8, eos_id=ref[j]))
        res = e2.run()[0]
        assert res.tokens == ref[:j + 1], (horizon, res.tokens)
        assert res.complete and e2.metrics["decode_steps"] == j + 1


def test_decode_horizon_env_default(monkeypatch, weights):
    monkeypatch.setenv("REPRO_DECODE_HORIZON", "3")
    params = weights[1]
    assert Engine(_cfg(), params, device="cpu", max_batch=1,
                  max_len=32).horizon == 3
    # an explicit argument wins over the env
    assert Engine(_cfg(), params, device="cpu", max_batch=1, max_len=32,
                  decode_horizon=1).horizon == 1
    with pytest.raises(ValueError, match="decode_horizon"):
        Engine(_cfg(), params, device="cpu", max_batch=1, max_len=32,
               decode_horizon=0)


def test_one_host_read_per_horizon(weights, monkeypatch):
    """step() runs min(horizon, longest remaining budget) device steps and
    reads their history once."""
    eng = Engine(_cfg(), weights[1], device="cpu", decode_horizon=4, **KW)
    reads = []
    orig = eng._read_history
    monkeypatch.setattr(eng, "_read_history",
                        lambda n: reads.append(n) or orig(n))
    for uid, p in enumerate(PROMPTS[:2]):
        eng.submit(Request(uid, p, max_new_tokens=6))
    assert eng.step() == 2
    assert reads == [4] and eng.metrics["decode_steps"] == 4
    assert eng.step() == 2                 # 2 tokens left: a 2-step horizon
    assert reads == [4, 2] and not eng._active


class _NoHostRead(TorchDispatchMode):
    """Raises on any op that reads a device value back to the host or
    makes a tensor from host data."""
    FORBIDDEN = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
                 torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.FORBIDDEN:
            raise AssertionError(f"host read in the decode body: {func}")
        return func(*args, **(kwargs or {}))


def _opaque(kernel):
    """The wrapper outside the dispatch mode: on the card it is one kernel
    launch, while its plain version (which the CPU runs) walks each row's
    listed pages in a host loop."""
    def call(*args, **kw):
        with _disable_current_modes():
            return kernel(*args, **kw)
    return call


#: decode routes of the body: the FUM kernel on the int8 grid pool (the
#: default), the block kernel, the FUM kernel on the fp8_v and the
#: unquantized pool, the plain stage 3 of an absmax pool, and the dense
#: layout's HDP decode; with HDP off, the paged and the dense layout
BODY_ROUTES = [(None, True), ("pallas_hdp_block", True),
               (TAttnSpec(kv_dtype="fp8_v"), True),
               (TAttnSpec(kv_dtype="fp32"), True),
               (TAttnSpec(kv_dtype="int8", kv_scale="absmax"), True),
               (TAttnSpec(layout="dense"), True),
               (TAttnSpec(kv_dtype="int8"), False),
               (TAttnSpec(layout="dense"), False)]


@pytest.mark.parametrize(
    "attn,hdp_on", BODY_ROUTES,
    ids=["None", "pallas_hdp_block", "fp8_v", "fp32", "absmax", "dense",
         "hdp_off-paged", "hdp_off-dense"])
def test_decode_body_reads_nothing_back(weights, attn, hdp_on, monkeypatch):
    monkeypatch.setattr(attention, "hdp_paged_fum_decode",
                        _opaque(hdp_paged_fum_decode))
    cfg = _cfg() if hdp_on else _cfg().replace(
        hdp=_cfg().hdp.replace(enabled=False))
    eng = Engine(cfg, weights[1], device="cpu", collect_stats=True,
                 attn=attn, **KW)
    prompt = PROMPTS[0]
    eng.submit(Request(0, prompt, max_new_tokens=4))
    eng._admit()
    eng._t.zero_()
    with _NoHostRead():
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            eng._t.sum().item()
        eng._decode_body()
    assert int(eng._t) == 1
    row = eng._hist[0]
    assert row[1].tolist() == [1, 0] and row[2].tolist() == [0, 0]
    assert int(eng._pos[0]) == len(prompt)
    assert eng._tok[0, 0] == row[0, 0] and eng._rem.tolist() == [3, 0]
    if hdp_on:
        assert bool(torch.isfinite(eng._hist_stats[0]).all())
    else:
        assert eng._hist_stats is None


class _EagerGraph:
    """Stands in for a captured CUDA graph: replay runs the body."""

    def __init__(self, body):
        self.replay = body


def test_replays_count_recorded_launches(weights, h1):
    """Each replay adds the launches recorded into the graph to the
    engine's counts, and leaves the wrappers' own counts alone: those
    count only the calls that reach a wrapper (a replay never does)."""
    eng = Engine(_cfg(), weights[1], device="cpu", decode_horizon=4, **KW)
    eng.cuda_graph = True
    eng._graph = _EagerGraph(eng._decode_body)
    n_layers = _cfg().n_layers
    eng._graph_launches = {"fum_kernel_launches": n_layers,
                           "block_kernel_launches": 0}
    before = dict(hdp_paged_fum_decode.launches_by_path)
    n0 = hdp_paged_fum_decode.launches
    for uid, p in enumerate(PROMPTS):
        eng.submit(Request(uid, p, max_new_tokens=_budget(uid)))
    toks = {u: r.tokens for u, r in eng.run().items()}
    assert hdp_paged_fum_decode.launches == n0
    assert hdp_paged_fum_decode.launches_by_path == before
    assert toks == h1
    s = eng.summary()
    assert s["decode_steps"] > 0
    assert s["fum_kernel_launches"] == n_layers * s["decode_steps"]
    assert s["block_kernel_launches"] == 0
