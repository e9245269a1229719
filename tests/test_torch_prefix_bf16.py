"""A prefix hit on a bf16 model (reduced qwen2-1.5b in bf16, int8 pool,
CPU, plain kernel versions).

The port's ``PagedKVCache.gather_prefix`` returns the shared prefix in
the model dtype, where the reference's ``_gather_fn`` returns fp32 for a
quantized pool (``src/repro/serving/kv_cache.py:565-599``). A cold
prefill's request cache is in the model dtype, and the suffix prefill
rounds p to V's dtype before P.V, so on a bf16 model the reference's hit
rounds p differently from its cold run. These tests pin what ROADMAP §3
records of it: on this traffic the reference's hit parts from its cold
run, the reference with its gather cast to the model dtype does not,
and the port's hit equals the port's cold run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)

MAX_NEW = 8
KW = dict(max_batch=2, max_len=96, prefill_buckets=(16, 32))


def _bf16(cfg):
    return cfg.replace(dtype="bfloat16",
                       hdp=cfg.hdp.replace(calib="none", head_pruning=False))


def _prompts():
    """Seed 0: a 24-token shared prompt, served first alone; then three
    suffix hits and one full hit."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 250, size=24).tolist()
    tails = [shared + rng.integers(1, 250, size=5 + i).tolist()
             for i in range(3)]
    return tails[0], tails[1:] + [shared[:12]]


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _serve(make, request):
    """The warm-up prompt alone, then the rest; tokens of the rest and
    the engine's prefix hits."""
    eng = make()
    first, rest = _prompts()
    eng.submit(request(0, first, max_new_tokens=MAX_NEW))
    eng.run()
    for uid, p in enumerate(rest, start=1):
        eng.submit(request(uid, p, max_new_tokens=MAX_NEW))
    res = eng.run()
    return ({u: r.tokens for u, r in res.items()},
            eng.summary().get("prefix_hits", 0))


@pytest.fixture(scope="module")
def weights():
    """The reference engine's own seeded bf16 weights, and the same
    values as the port's dict."""
    cfg = _bf16(jax_reduced(jax_get_config("qwen2-1.5b")))
    tree = JEngine(cfg, **KW).params
    return tree, params_from_jax(_bf16(reduced(get_config("qwen2-1.5b"))),
                                 jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The reference's tokens cold, hot, and hot with its gather cast to
    the model dtype."""
    cfg = _bf16(jax_reduced(jax_get_config("qwen2-1.5b")))

    def run(prefix):
        return _serve(lambda: JEngine(cfg, params=weights[0],
                                      prefix_cache=prefix, **KW), JRequest)

    out = {"cold": run(False), "hot": run(True)}
    orig = jax_kv_cache.PagedKVCache._gather_fn

    def cast(self, pool, idx):
        return {k: v.astype(jnp.bfloat16)
                for k, v in orig(self, pool, idx).items()}

    jax_kv_cache.PagedKVCache._gather_fn = cast
    try:
        out["hot_cast"] = run(True)
    finally:
        jax_kv_cache.PagedKVCache._gather_fn = orig
    return out


@pytest.fixture(scope="module")
def port_runs(weights):
    """The port's tokens cold and hot."""
    cfg = _bf16(reduced(get_config("qwen2-1.5b")))
    return {name: _serve(lambda: Engine(cfg, weights[1], device="cpu",
                                        prefix_cache=prefix, **KW), Request)
            for name, prefix in (("cold", False), ("hot", True))}


def test_reference_fp32_gather_parts_hot_from_cold(jax_runs):
    """The fault ROADMAP §3 records: the reference's fp32 gather makes a
    bf16 hit differ from cold, and casting it to the model dtype
    removes the difference."""
    (cold, _), (hot, hits), (cast, cast_hits) = (
        jax_runs["cold"], jax_runs["hot"], jax_runs["hot_cast"])
    assert hits == cast_hits == 3
    assert hot != cold
    assert cast == cold


def test_port_bf16_hit_equals_cold(port_runs):
    """The port's gather in the model dtype: hit tokens equal the cold
    run's on the traffic where the reference's parts from them. (Token
    equality with the reference is held on the fp32 reduced config in
    ``test_torch_prefix_cache.py``: in bf16 the two frameworks' CPU
    matmuls round apart, already on a cold request.)"""
    (cold, _), (hot, hits) = port_runs["cold"], port_runs["hot"]
    assert hits == 3
    assert hot == cold
