"""Port parity of the dense model stack on reduced qwen2-1.5b: the same
weights (moved with ``params_from_jax``) and token ids give the same
prefill logits, the same int8 pool codes and the same paged-decode
logits as the JAX package, at fp32 within atol 1e-4 (matrix products
sum in another order in the two frameworks), and the aligned
self-attention prefill gives the JAX package's logits and HDP stats on
every backend that serves it."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import registry as jregistry
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.attention import AttnSpec as TAttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving.kv_cache import PagedKVCache

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL = 1e-4
PLENS = (13, 9)
BUCKET = 16
MAX_LEN = 32


def _cfgs(calib="none"):
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(calib=calib))
    cfg = reduced(get_config("qwen2-1.5b"))
    return cfg.replace(hdp=cfg.hdp.replace(calib=calib)), jcfg


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(PLENS), BUCKET), np.int32)
    for r, n in enumerate(PLENS):
        toks[r, :n] = rng.integers(1, 250, n)
        toks[r, n:] = toks[r, n - 1]          # the engine's right padding
    return toks


@pytest.fixture(scope="module")
def weights():
    _, jcfg = _cfgs()
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, jax.tree.map(np.asarray, jparams)


def test_params_from_jax_copies_every_leaf(weights):
    jparams, tree = weights
    cfg, _ = _cfgs()
    params = params_from_jax(cfg, tree, "cpu")
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_t[path] = node
    walk(params, ())
    flat_j = {tuple(getattr(k, "key", k) for k in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    assert set(flat_t) == set(flat_j)
    for path, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[path].numpy(), leaf,
                                      err_msg="/".join(path))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg.replace(d_ff=96), tree, "cpu")


def test_params_from_jax_bfloat16_bits():
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b")).replace(dtype="bfloat16")
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="bfloat16")
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    w = params["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jparams["layers"]["attn"]["wq"].astype(jnp.float32)))


@pytest.mark.parametrize("calib,seed", [("none", 0), ("max", 0),
                                        ("none", 2)])
def test_prefill_logits_match(weights, calib, seed):
    """Prefill into a request cache of an int8-pool engine: K/V snapped
    to the pool grid, under both the static and the "max" calibration."""
    _, tree = weights
    cfg, jcfg = _cfgs(calib)
    toks = _tokens(seed)
    spec = AttnSpec(backend="xla", kv_dtype="int8")
    jl, jc, jst = jregistry.apply_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)},
        jregistry.init_cache(jcfg, len(PLENS), BUCKET), attn=spec,
        collect_stats=True)
    params = params_from_jax(cfg, tree, "cpu")
    with torch.no_grad():
        tl, tc, tst = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            registry.init_cache(cfg, len(PLENS), BUCKET, device="cpu"),
            attn=TAttnSpec(backend="xla", kv_dtype="int8"),
            collect_stats=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)
    for name in ("block_sparsity", "head_sparsity"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=1e-6, rtol=0)


def test_paged_decode_logits_and_pool_match(weights):
    """Prefill, insert into the int8 pool, then two paged decode steps
    (the engine's resume replay, then a fresh token): pool codes equal
    exactly, logits within atol."""
    _, tree = weights
    cfg, jcfg = _cfgs()
    toks = _tokens(1)
    spec = AttnSpec(backend="xla", kv_dtype="int8")
    jparams = jax.tree.map(jnp.asarray, tree)
    _, jc, _ = jregistry.apply_prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks)},
        jregistry.init_cache(jcfg, len(PLENS), BUCKET), attn=spec)
    params = params_from_jax(cfg, tree, "cpu")
    with torch.no_grad():
        _, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            registry.init_cache(cfg, len(PLENS), BUCKET, device="cpu"),
            attn=TAttnSpec(backend="xla", kv_dtype="int8"))
    jpages = JPagedKVCache(jcfg, len(PLENS), MAX_LEN, kv_dtype="int8")
    pages = PagedKVCache(cfg, len(PLENS), MAX_LEN, device="cpu")
    for slot, n in enumerate(PLENS):
        jpages.alloc(slot, n + 6)
        jpages.insert(jc, slot, row=slot)
        pages.alloc(slot, n + 6)
        pages.insert(tc, slot, row=slot)
    np.testing.assert_array_equal(pages.table().numpy(),
                                  np.asarray(jpages.table()))
    for name in pages.cache:
        np.testing.assert_array_equal(pages.cache[name].numpy(),
                                      np.asarray(jpages.cache[name]),
                                      err_msg=name)

    tok = np.asarray([[toks[r, n - 1]] for r, n in enumerate(PLENS)], np.int32)
    pos = np.asarray([[n - 1] for n in PLENS], np.int32)
    for step in range(2):
        jl, jcache, jst = jregistry.apply_decode(
            jcfg, jparams, jnp.asarray(tok), jpages.cache, jnp.asarray(pos),
            page_table=jpages.table(), attn=spec, collect_stats=True)
        jpages.cache = jcache
        with torch.no_grad():
            tl, _, tst = registry.apply_decode(
                cfg, params, torch.from_numpy(tok).long(), pages.cache,
                torch.from_numpy(pos).long(), page_table=pages.table(),
                collect_stats=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(pages.cache[name].numpy(),
                                          np.asarray(jcache[name]),
                                          err_msg=f"{name} step {step}")
        for name in ("block_sparsity", "head_sparsity", "page_sparsity"):
            np.testing.assert_array_equal(tst[name].numpy(),
                                          np.asarray(jst[name]),
                                          err_msg=f"{name} step {step}")
        tok = np.array(jl[:, -1].argmax(-1), np.int32)[:, None]
        pos = pos + 1


# ------------------------------------------------ aligned self-attention
ALIGNED = [("pallas_hdp_block", True), ("xla_hdp", True),
           ("reference", True), ("pallas_flash", False),
           ("xla_dense", False), ("reference", False)]


@pytest.mark.parametrize("backend,hdp_on", ALIGNED,
                         ids=[f"{b}-{'hdp' if h else 'dense'}"
                              for b, h in ALIGNED])
def test_aligned_prefill_matches_jax(weights, backend, hdp_on):
    """``apply_prefill(..., cache=None)`` — the full-sequence call — on
    each backend that serves it, pinned without fallback, under qwen2's
    default "max" calibration: logits within atol 1e-4, sparsity stats
    equal, theta_head within rtol 1e-5. The HDP-off cells convert the
    weights with an HDP-off config."""
    _, tree = weights
    cfg, jcfg = _cfgs("max")
    if not hdp_on:
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
        jcfg = jcfg.replace(hdp=jcfg.hdp.replace(enabled=False))
    toks = _tokens(4)
    jl, _, jst = jregistry.apply_prefill(
        jcfg, jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)},
        None, attn=AttnSpec(backend=backend, allow_fallback=False),
        collect_stats=True)
    params = params_from_jax(cfg, tree, "cpu")
    with torch.no_grad():
        tl, tc, tst = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()}, None,
            attn=TAttnSpec(backend=backend, allow_fallback=False),
            collect_stats=True)
    assert tc is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    if not hdp_on:
        assert tst is None and jst is None
        return
    for name in ("block_sparsity", "head_sparsity"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(tst["theta_head"].numpy(),
                               np.asarray(jst["theta_head"]), rtol=1e-5)


def test_aligned_prefill_resolves_like_jax_on_tpu(monkeypatch):
    """The default spec picks the full-sequence kernels for the aligned
    call (the reference's TPU order) and xla_hdp for the request-cache
    prefill."""
    import repro.attention.registry as jreg_mod
    from repro.models.attention import build_attn_call as jbuild
    from repro_torch.attention import resolve_backend
    from repro_torch.models.attention import build_attn_call
    monkeypatch.setattr(jreg_mod, "_on_tpu", lambda: True)
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    cfg, jcfg = _cfgs("max")
    for on in (True, False):
        c = cfg.replace(hdp=cfg.hdp.replace(enabled=on))
        jc = jcfg.replace(hdp=jcfg.hdp.replace(enabled=on))
        for aligned in (True, False):
            got = resolve_backend(build_attn_call(
                c, mode="prefill", self_aligned=aligned)).name
            want = jreg_mod.resolve_backend(jbuild(
                jc, mode="prefill", self_aligned=aligned)).name
            assert got == want, (on, aligned)
    assert resolve_backend(build_attn_call(
        cfg, mode="prefill", self_aligned=True)).name == "pallas_hdp_block"


def _jax_bf16_prefill_rounding_wo(jcfg, jparams, toks, spec):
    """The reference's own layers, composed by hand with the port's rule
    for a bf16 model: each layer's attention output (fp32 under the
    block kernel) is rounded to bf16 before the residual sum."""
    from repro.models import layers as JL
    from repro.models.attention import attn_apply as jattn_apply
    from repro.models.transformer import _embed_in
    x = _embed_in(jcfg, jparams, jnp.asarray(toks))
    positions = jnp.arange(toks.shape[1])
    ys = []
    for li in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[li], jparams["layers"])
        h = JL.apply_norm(jcfg, lp["ln1"], x)
        y, _, _ = jattn_apply(jcfg, lp["attn"], h, mode="prefill",
                              positions=positions, cache=None, attn=spec)
        ys.append(y)
        x = x + y.astype(x.dtype)
        h = JL.apply_norm(jcfg, lp["ln2"], x)
        x = x + JL.mlp_apply(jcfg, lp["ffn"], h)
    x = JL.apply_norm(jcfg, jparams["final_norm"], x[:, -1:])
    return JL.lm_logits_sharded(jparams["embed"], x), ys


def test_bf16_block_kernel_prefill_keeps_model_dtype(weights):
    """The block kernel returns fp32 (qq's dtype), so a bf16 model's
    attention output meets bf16 ``wo`` in fp32, as the reference
    promotes it. The reference's ``lax.scan`` over layers then rejects
    the fp32 carry (a fault of the reference, ROADMAP.md section 3); the
    port rounds the projection to bf16 and serves. Pinned against the
    reference's own layers composed with that rounding: the first
    layer's projection within one bf16 step, the logits within the bf16
    tolerance 2e-2."""
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.layers import embed_tokens, rms_norm
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b")).replace(dtype="bfloat16")
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="bfloat16")
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(1))
    toks = _tokens(5)
    spec = AttnSpec(backend="pallas_hdp_block")
    with pytest.raises(TypeError, match="carry"):
        jregistry.apply_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                None, attn=spec)
    want, jys = _jax_bf16_prefill_rounding_wo(jcfg, jparams, toks, spec)
    assert jys[0].dtype == jnp.float32
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    t = torch.from_numpy(toks).long()
    tspec = TAttnSpec(backend="pallas_hdp_block")
    with torch.no_grad():
        lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
        h = rms_norm(embed_tokens(params["embed"], t),
                     params["layers"]["ln1"]["w"][0])
        y, _, _ = attn_apply(cfg, lp, h, mode="prefill",
                             positions=torch.arange(t.shape[1]), attn=tspec)
        tl, _, _ = registry.apply_prefill(cfg, params, {"tokens": t}, None,
                                          attn=tspec)
    assert y.dtype == torch.bfloat16
    jy = jys[0].astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy),
                               atol=2 ** -8, rtol=2 ** -7)
    assert tl.dtype == torch.float32 and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "rwkv6", "zamba2",
                                    "whisper", "not-a-family"])
def test_family_resolves_like_jax(family):
    """Every family the reference serves resolves to the port's module of
    the same name (the transformer for dense, moe and vlm); an unknown
    family raises KeyError in both packages."""
    cfg = reduced(get_config("qwen2-1.5b")).replace(family=family)
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b")).replace(family=family)
    if family == "not-a-family":
        with pytest.raises(KeyError, match="unknown family"):
            jregistry.module_for(jcfg)
        with pytest.raises(KeyError, match="unknown family"):
            registry.module_for(cfg)
        return
    want = jregistry.module_for(jcfg).__name__.rsplit(".", 1)[1]
    got = registry.module_for(cfg).__name__
    assert got == f"repro_torch.models.{want}"
