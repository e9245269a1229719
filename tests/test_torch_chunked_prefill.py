"""Port parity of chunked prefill on reduced qwen2-1.5b (CPU, plain
kernel versions): a prompt longer than the largest bucket is prefilled
in chunks of the largest bucket at a position offset, the last chunk
padded to the smallest bucket that fits (``_tail_len``).

* ``apply_prefill(..., pos_offset=)`` chunk by chunk gives the JAX
  package's logits, request cache and HDP stats, and on the engine's
  static grid its last chunk gives the one-shot prefill's logits: each
  chunk attends to the whole cached prefix, and the scout pools the same
  blocks;
* the engine serves a 40-token prompt with buckets (8, 16) with the JAX
  engine's tokens and counters, and with its own one-shot tokens
  (buckets (64,), tau_h 0, as ``tests/test_paged_cache.py`` pins for the
  reference);
* ``_tail_len`` picks the JAX engine's last chunk, and ``submit`` still
  raises where the engine cannot chunk.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec
from repro_torch.attention import AttnSpec as TAttnSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import registry as jregistry
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL = 1e-4
KW = dict(max_batch=2, max_len=64, prefill_buckets=(8, 16))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


LONG = _prompts(1, lo=40, hi=41, seed=9)[0]      # 40 > the largest bucket
#: the long prompt between two short ones: admission prefills the short
#: group first, then the long prompt alone
PROMPTS = [LONG, _prompts(1, lo=10, hi=11, seed=4)[0],
           _prompts(1, lo=20, hi=21, seed=5)[0]]


def _cfg():
    return reduced(get_config("qwen2-1.5b"))


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's default weights (key 0), as the reference's own
    chunked-prefill test draws them, and their port through
    ``params_from_jax``. Chunked and one-shot prefill agree only where no
    head's integer scout sums to zero over one chunk but not over the
    prompt (the early head gate applies per forward call, even at
    tau_h = 0); seed-0 weights of the port's own init miss that in both
    packages alike."""
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    # one compiled init (the same values as the eager one, faster)
    jparams = jax.jit(lambda key: jregistry.init_params(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    return jparams, params_from_jax(_cfg(), jax.tree.map(np.asarray, jparams),
                                    "cpu")


@pytest.fixture(scope="module")
def jax_served(weights):
    jeng = JEngine(jax_reduced(jax_get_config("qwen2-1.5b")),
                   params=weights[0],
                   attn=AttnSpec(backend="xla", kv_dtype="int8"),
                   decode_horizon=1, prefix_cache=False, spec_decode=False,
                   stream_sched=False, collect_stats=True, **KW)
    for uid, p in enumerate(PROMPTS):
        jeng.submit(JRequest(uid, p, max_new_tokens=5))
    return jeng, {u: r.tokens for u, r in jeng.run().items()}


def _serve(params, prompts, **kw):
    eng = Engine(_cfg(), params, device="cpu", **{**KW, **kw})
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=5))
    return eng, {u: r.tokens for u, r in eng.run().items()}


def test_prefill_chunks_match_jax(weights):
    """Chunk by chunk at offsets 0, 16, 32 (the tail chunk 8 long) into a
    64-position request cache: the JAX package's logits and stats at
    every chunk, and its cache at the end."""
    jparams, params = weights
    cfg, jcfg = _cfg(), jax_reduced(jax_get_config("qwen2-1.5b"))
    spec = AttnSpec(backend="xla", kv_dtype="int8")
    toks = np.asarray(LONG, np.int32)[None]
    jcache = jregistry.init_cache(jcfg, 1, 64)
    cache = registry.init_cache(cfg, 1, 64, device="cpu")
    for off, n in ((0, 16), (16, 16), (32, 8)):
        piece = toks[:, off:off + n]
        jl, jcache, jst = jregistry.apply_prefill(
            jcfg, jparams, {"tokens": jnp.asarray(piece)}, jcache,
            collect_stats=True, pos_offset=off, attn=spec)
        with torch.no_grad():
            tl, cache, tst = registry.apply_prefill(
                cfg, params, {"tokens": torch.from_numpy(piece).long()},
                cache, collect_stats=True, pos_offset=off,
                attn=TAttnSpec(backend="xla", kv_dtype="int8"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"offset {off}")
        for name in ("block_sparsity", "head_sparsity"):
            np.testing.assert_allclose(tst[name].numpy(),
                                       np.asarray(jst[name]), atol=1e-6,
                                       rtol=0, err_msg=f"{name} at {off}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("tail", [8, 16])
def test_prefill_chunks_match_one_shot(weights, tail):
    """On the serving engine's static grid (calib "none": a calibration
    scale is per call), the chunks (the tail chunk padded to ``tail``)
    give the one-shot prefill's last logits and cache: each chunk attends
    to the whole cached prefix, and its scout pools the one-shot's
    blocks."""
    cfg = _cfg()
    cfg = cfg.replace(hdp=cfg.hdp.replace(calib="none"))
    params = weights[1]
    toks = torch.tensor([LONG])
    cache = registry.init_cache(cfg, 1, 64, device="cpu")
    with torch.no_grad():
        for off, n in ((0, 16), (16, 16), (32, tail)):
            piece = toks[:, off:off + n]          # padded with the last
            piece = torch.cat(
                [piece, piece[:, -1:].expand(1, n - piece.shape[1])], dim=1)
            tl, _, _ = registry.apply_prefill(
                cfg, params, {"tokens": piece}, cache, pos_offset=off)
        one, one_cache, _ = registry.apply_prefill(
            cfg, params, {"tokens": toks},
            registry.init_cache(cfg, 1, 64, device="cpu"))
        if tail > 8:         # the padded tail's last row is position 47
            one, _, _ = registry.apply_prefill(
                cfg, params, {"tokens": torch.cat(
                    [toks, toks[:, -1:].expand(1, 8)], dim=1)},
                registry.init_cache(cfg, 1, 64, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), one.numpy(), atol=1e-5, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :40].numpy(),
                                   one_cache[name][:, :, :40].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_chunked_prefill_matches_jax_engine(weights, jax_served):
    jeng, jtok = jax_served
    eng, tok = _serve(weights[1], PROMPTS, collect_stats=True)
    assert tok == jtok
    assert all(len(t) == 5 for t in tok.values())
    js, ts = jeng.summary(), eng.summary()
    for key in ("prefill_calls", "prefill_tokens", "decode_steps",
                "tokens_out", "block_sparsity", "head_sparsity",
                "page_sparsity", "pages_peak"):
        assert ts[key] == js[key], key
    eng.pages.allocator.assert_drained()


def test_chunked_prefill_matches_one_shot(weights):
    """Exact at tau_h = 0, where the early head gate, which applies per
    forward call, gates alike."""
    assert _cfg().hdp.tau_h == 0.0
    eng, chunked = _serve(weights[1], [LONG])
    assert eng.metrics["prefill_calls"] == 1
    assert eng.metrics["prefill_tokens"] == 40    # chunks 16 + 16 + 8
    _, one = _serve(weights[1], [LONG], prefill_buckets=(64,))
    assert chunked == one


def test_chunk_offsets(weights, monkeypatch):
    """A 40-token prompt runs chunks at offsets 0, 16 and 32; the last
    one pads to bucket 8."""
    eng = Engine(_cfg(), weights[1], device="cpu", **KW)
    seen = []
    orig = eng._chunk_step
    monkeypatch.setattr(eng, "_chunk_step", lambda p, c, off: seen.append(
        (off, orig(p, c, off))) or seen[-1][1])
    eng.submit(Request(0, LONG[:37], max_new_tokens=5))
    eng.run()
    assert seen == [(0, 16), (16, 32), (32, 40)]
    assert eng.metrics["prefill_tokens"] == 40


@pytest.mark.parametrize("buckets,max_len", [((8, 16), 64), ((4, 16), 40),
                                             ((16,), 40)])
def test_tail_len_matches_jax_engine(weights, buckets, max_len):
    """The last chunk: the smallest bucket that holds the rest and fits
    below max_len, else the exact remainder."""
    kw = dict(max_batch=1, max_len=max_len, prefill_buckets=buckets)
    jeng = JEngine(jax_reduced(jax_get_config("qwen2-1.5b")),
                   params=weights[0],
                   attn=AttnSpec(backend="xla", kv_dtype="int8"),
                   prefix_cache=False, spec_decode=False, stream_sched=False,
                   **kw)
    eng = Engine(_cfg(), weights[1], device="cpu", **kw)
    got = {(rem, off): eng._tail_len(rem, off)
           for off in range(0, max_len, 16) for rem in range(1, 17)}
    assert got == {k: jeng._tail_len(*k) for k in got}
    if max_len == 40:      # no bucket of 5 or more fits past 32
        assert eng._tail_len(5, 32) == 5


def test_submit_raises_where_engine_cannot_chunk(weights):
    params = weights[1]
    Engine(_cfg(), params, device="cpu", max_batch=1, max_len=64,
           prefill_buckets=(16,)).submit(Request(0, LONG, max_new_tokens=4))
    eng = Engine(_cfg(), params, device="cpu", max_batch=1, max_len=64,
                 prefill_buckets=(8, 15))
    assert not eng._can_chunk
    eng.submit(Request(0, LONG[:15], max_new_tokens=4))     # fits a bucket
    with pytest.raises(ValueError, match=r"largest prefill bucket \(15\).*"
                                         r"multiple of HDP's block_q \(2\)"):
        eng.submit(Request(1, LONG, max_new_tokens=4))
