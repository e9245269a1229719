"""Port parity of the dense slot layout, HDP-off serving, the pool formats
and sliding-window attention.

* ``test_paged_decode_equals_dense_decode`` ports the reference's
  property (``tests/test_paged_cache.py``): the port's paged engine on
  the unquantized pool and its dense-layout engine emit the same tokens,
  with HDP off, on the static grid, and as registered (the paged engine
  pins calib "none").
* The port's ``Engine`` on the CPU (plain kernel versions) and the JAX
  ``Engine`` serve the same prompts with the same weights and must emit
  byte-identical greedy tokens on reduced qwen2-1.5b and reduced
  granite-8b: HDP off on the paged and the dense layout, and HDP on on
  the dense layout (each pool format of the paged layout:
  ``test_torch_pool_serving.py``). The JAX engine pins per-token decode,
  no prefix cache, no speculation and no stream scheduler.
* ``local_attention`` (the windowed aligned prefill) and the windowed
  paged decode against JAX's on reduced h2o-danube (window 16), to 1e-5.
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
from repro.models import attention as JA
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as A
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
ATOL = 1e-5   # fp32 sums in another order; masks and positions are exact


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _cfgs(arch, hdp_on=True):
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    if not hdp_on:
        jcfg = jcfg.replace(hdp=jcfg.hdp.replace(enabled=False))
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    return jcfg, cfg


def _run(eng, R, prompts, max_new):
    for uid, p in enumerate(prompts):
        eng.submit(R(uid, p, max_new_tokens=max_new))
    return {u: r.tokens for u, r in eng.run().items()}


def _serve_both(arch, hdp_on, spec_kw, prompts, max_new=4):
    """(JAX tokens, port tokens, JAX summary, port summary) with the same
    weights and the same cache spec."""
    jcfg, cfg = _cfgs(arch, hdp_on)
    jeng = JEngine(jcfg, attn=JSpec(backend="xla", **spec_kw),
                   decode_horizon=1, prefix_cache=False, spec_decode=False,
                   stream_sched=False, collect_stats=True, **KW)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jeng.params),
                             "cpu")
    eng = Engine(cfg, params, device="cpu", attn=AttnSpec(**spec_kw),
                 collect_stats=True, **KW)
    jtok = _run(jeng, JRequest, prompts, max_new)
    tok = _run(eng, Request, prompts, max_new)
    return jtok, tok, jeng.summary(), eng.summary()


# ------------------------------------------------------- paged == dense
@pytest.mark.parametrize("mode", ["hdp_off", "hdp_calib_none", "hdp_stock"])
def test_paged_decode_equals_dense_decode(mode):
    """The port's paged engine (unquantized pool) and dense engine emit
    the same tokens: with HDP off, on the static grid, and as registered
    (calib "max": the paged engine pins calib "none", so it matches a
    dense engine given that effective config)."""
    cfg = reduced(get_config("qwen2-1.5b"))
    if mode == "hdp_off":
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    elif mode == "hdp_calib_none":
        cfg = cfg.replace(hdp=cfg.hdp.replace(calib="none"))
    prompts = _prompts(4, seed=3)
    eng = Engine(cfg, seed=0, device="cpu", attn=AttnSpec(kv_dtype="fp32"),
                 **KW)
    paged = _run(eng, Request, prompts, 5)
    if mode == "hdp_stock":
        assert eng.cfg.hdp.calib == "none", "paged engine must pin calib"
        cfg = cfg.replace(hdp=cfg.hdp.replace(calib="none"))
    dense_eng = Engine(cfg, eng.params, device="cpu",
                       attn=AttnSpec(layout="dense"), **KW)
    dense = _run(dense_eng, Request, prompts, 5)
    assert paged == dense, f"{mode}: paged {paged} != dense {dense}"
    assert dense_eng.summary()["layout"] == "dense"
    assert not dense_eng.slots.cache["k"].any(), "finished slots not cleared"


# ---------------------------------------------- serving parity with JAX
SERVE_CELLS = [
    # (hdp on, cache spec)
    (False, dict(layout="paged", kv_dtype="int8")),
    (False, dict(layout="dense")),
    (True, dict(layout="dense")),
]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-8b"])
@pytest.mark.parametrize("hdp_on,spec_kw", SERVE_CELLS,
                         ids=[f"{'hdp' if h else 'nohdp'}-"
                              + "-".join(map(str, kw.values()))
                              for h, kw in SERVE_CELLS])
def test_greedy_tokens_equal_jax_engine(arch, hdp_on, spec_kw):
    """Greedy tokens byte-identical to the JAX engine's, with the same
    resolved prefill backend, pool format and cache bytes."""
    check_serving_parity(arch, hdp_on, spec_kw)


def check_serving_parity(arch, hdp_on, spec_kw):
    """Two prompts, three new tokens each, through both engines."""
    prompts = _prompts(2, lo=6, hi=16, seed=7)
    jtok, tok, js, ts = _serve_both(arch, hdp_on, spec_kw, prompts, 3)
    assert tok == jtok
    assert all(len(t) == 3 for t in tok.values())
    for key in ("attn_backend_prefill", "kv_dtype", "cache_bytes"):
        assert ts[key] == js[key], key
    if ts["layout"] == "paged":
        for key in ("kv_scale", "cache_bytes_per_token", "page_size",
                    "pages_peak"):
            assert ts[key] == js[key], key
    if hdp_on:
        for key in ("block_sparsity", "head_sparsity"):
            assert ts[key] == pytest.approx(js[key], abs=1e-6), key


def test_engine_rejects_absmax_without_a_quantized_pool():
    cfg = reduced(get_config("qwen2-1.5b"))
    for kw in (dict(kv_dtype="fp32", kv_scale="absmax"),
               dict(layout="dense", kv_scale="absmax")):
        with pytest.raises(ValueError, match="absmax"):
            Engine(cfg, seed=0, device="cpu", attn=AttnSpec(**kw), **KW)


# ------------------------------------------------------- sliding window
def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("S", [16, 40])
def test_local_attention_matches_jax(S):
    """The block-local sliding window (window 16, h2o-danube's reduced
    one) over aligned self-attention, at one block and at a ragged
    2.5 blocks."""
    B, N, G, hd, w = 2, 2, 2, 16, 16
    q, k, v = _np(1, B, N, G, S, hd), _np(2, B, S, N, hd), _np(3, B, S, N, hd)
    pos = np.arange(S)
    want = JA.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                              window=w)
    got = A.local_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), q_pos=torch.from_numpy(pos),
                            k_pos=torch.from_numpy(pos), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp32"])
def test_windowed_paged_decode_matches_jax(kv_dtype):
    """Reduced h2o-danube (window 16) through both engines, prompts of
    20-40 tokens: the windowed paged decode (``paged_hdp_decode``, stage
    3 on page chunks) and the windowed prefill give JAX's tokens."""
    prompts = [np.random.default_rng(9).integers(1, 250, size=n).tolist()
               for n in (20, 30, 40)]
    jtok, tok, js, ts = _serve_both("h2o-danube-1.8b", True,
                                    dict(kv_dtype=kv_dtype), prompts)
    assert tok == jtok
    assert ts["attn_backend_decode"] == js["attn_backend_decode"] \
        == "paged_hdp_decode"
    assert ts["block_sparsity"] == pytest.approx(js["block_sparsity"],
                                                 abs=1e-6)
