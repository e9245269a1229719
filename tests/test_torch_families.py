"""Port parity of the moe and vlm model stack and the configs it serves:
olmoe-1b-7b (64 experts top-8, qk-norm, MHA), llama4-scout-17b-a16e (16
experts top-1 + a shared expert), chameleon-34b (vlm, qk-norm) and
nemotron-4-15b (squared-ReLU MLP), with the GELU MLP and LayerNorm
branches on top (fp32 reduced configs, CPU, plain kernel versions).

* every config's fields equal the reference's, full and reduced, and
  the registry serves the dense, moe and vlm families with the
  transformer;
* prefill logits into an int8-pool engine's request cache within 1e-5
  of JAX's, the K/V it holds within 1e-5, the pool codes after the
  insert and after two paged decode steps exactly equal, and the decode
  logits within 1e-4 (matrix products sum in another order);

Serving parity on the same configs: ``test_torch_families_serving.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import registry as jregistry
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry, transformer
from repro_torch.serving import Engine
from repro_torch.serving.kv_cache import PagedKVCache

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "chameleon-34b",
         "nemotron-4-15b")
#: (arch, fields replaced on both configs): the four configs, then the
#: GELU MLP (dense with biases, and in the experts) and LayerNorm
CASES = [(a, {}) for a in ARCHS] + [
    ("nemotron-4-15b", dict(act="gelu")),
    ("olmoe-1b-7b", dict(act="gelu")),
    ("chameleon-34b", dict(norm="layernorm")),
]
CASE_IDS = [a + "".join(f"-{v}" for v in kw.values()) for a, kw in CASES]
PREFILL_ATOL, DECODE_ATOL = 1e-5, 1e-4
PLENS, BUCKET, MAX_LEN = (13, 9), 16, 32
KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))


def _cfgs(arch, **kw):
    return (reduced(get_config(arch)).replace(**kw),
            jax_reduced(jax_get_config(arch)).replace(**kw))


# -------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      _cfgs(arch)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.hd == jcfg.hd
        assert registry.module_for(cfg) is transformer
        assert cfg.param_count() == jregistry.param_count(jcfg)
        assert registry.param_count(cfg, active_only=True) \
            == jregistry.param_count(jcfg, active_only=True)


def test_every_transformer_family_config_is_served():
    """The transformer serves every registered config of the dense, moe
    and vlm families; the recurrent and encoder-decoder configs have
    modules of their own (``test_torch_rwkv6.py``, ``_zamba2.py``,
    ``_whisper.py``)."""
    from repro_torch.configs.base import _REGISTRY
    fams = {get_config(n).family for n in _REGISTRY}
    assert fams == {"dense", "moe", "vlm", "rwkv6", "zamba2", "whisper"}
    for name in _REGISTRY:
        cfg = get_config(name)
        if cfg.family in ("dense", "moe", "vlm"):
            assert registry.module_for(cfg) is transformer, name
        else:
            assert registry.module_for(cfg).__name__ == \
                f"repro_torch.models.{cfg.family}", name


def test_engine_keeps_pages_for_pageable_families():
    """A family without a seq-indexed cache is refused the paged layout
    and speculative verify, as in the reference."""
    cfg, _ = _cfgs("olmoe-1b-7b")
    params = registry.init_params(cfg, 0, "cpu")
    rwkv = cfg.replace(family="rwkv6")
    with pytest.raises(ValueError, match="no KV pages"):
        Engine(rwkv, params, device="cpu", attn=AttnSpec(layout="paged"),
               **KW)
    with pytest.raises(ValueError, match="multi-query"):
        Engine(rwkv, params, device="cpu", attn=AttnSpec(layout="dense"),
               spec_decode=True, **KW)


# ---------------------------------------------------------- model logits
def _tokens(seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(PLENS), BUCKET), np.int32)
    for r, n in enumerate(PLENS):
        toks[r, :n] = rng.integers(1, 250, n)
        toks[r, n:] = toks[r, n - 1]          # the engine's right padding
    return toks


#: leaves the reference initialises to ones or zeros (norm weights and
#: biases, qk-norm, the GELU MLP's biases): drawn afresh, so that a
#: weight applied in the wrong place shows
_CONST_LEAVES = ("q_norm", "k_norm", "w", "b", "b1", "b2")


def _perturbed(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, k) for k, v in tree.items()}
    if name in _CONST_LEAVES:
        return (tree + rng.normal(0, 0.3, tree.shape)).astype(tree.dtype)
    return tree


@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
def test_prefill_and_decode_logits_match_jax(arch, kw):
    """Prefill into an int8-pool engine's request cache, insert into the
    pool, then two paged decode steps (the engine's resume replay, then
    a fresh token)."""
    cfg, jcfg = _cfgs(arch, **kw)
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tree = _perturbed(jax.tree.map(np.asarray, jparams),
                      np.random.default_rng(2))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(cfg, tree, "cpu")
    spec = JSpec(backend="xla", kv_dtype="int8")
    toks = _tokens(1)
    jl, jc, _ = jregistry.apply_prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks)},
        jregistry.init_cache(jcfg, len(PLENS), BUCKET), attn=spec)
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            registry.init_cache(cfg, len(PLENS), BUCKET, device="cpu"),
            attn=AttnSpec(backend="xla", kv_dtype="int8"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=PREFILL_ATOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=PREFILL_ATOL, rtol=0, err_msg=name)
    jpages = JPagedKVCache(jcfg, len(PLENS), MAX_LEN, kv_dtype="int8")
    pages = PagedKVCache(cfg, len(PLENS), MAX_LEN, device="cpu")
    for slot, n in enumerate(PLENS):
        jpages.alloc(slot, n + 6)
        jpages.insert(jc, slot, row=slot)
        pages.alloc(slot, n + 6)
        pages.insert(tc, slot, row=slot)
    for name in pages.cache:
        np.testing.assert_array_equal(pages.cache[name].numpy(),
                                      np.asarray(jpages.cache[name]),
                                      err_msg=name)
    tok = np.asarray([[toks[r, n - 1]] for r, n in enumerate(PLENS)],
                     np.int32)
    pos = np.asarray([[n - 1] for n in PLENS], np.int32)
    for step in range(2):
        jl, jcache, _ = jregistry.apply_decode(
            jcfg, jparams, jnp.asarray(tok), jpages.cache, jnp.asarray(pos),
            page_table=jpages.table(), attn=spec)
        jpages.cache = jcache
        with torch.no_grad():
            tl, _, _ = registry.apply_decode(
                cfg, params, torch.from_numpy(tok).long(), pages.cache,
                torch.from_numpy(pos).long(), page_table=pages.table())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(pages.cache[name].numpy(),
                                          np.asarray(jcache[name]),
                                          err_msg=f"{name} step {step}")
        tok = np.array(jl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1
