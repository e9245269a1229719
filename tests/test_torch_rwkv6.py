"""Port parity of the rwkv6 family (``repro_torch.models.rwkv6``) on
reduced rwkv6-3b (fp32, CPU): the same seeded inputs and weights (moved
with ``params_from_jax``) through the JAX function and the port's.

* ``_wkv_scan`` (the WKV-6 recurrence over an fp32 state) and
  ``layers.group_norm_heads`` against the reference functions;
* ``apply_prefill`` on a fresh cache at prompt lengths 1, 6 and 13, then
  eight greedy ``apply_decode`` steps: the logits and every cache leaf
  (``state``, ``tm_x``, ``cm_x``) within atol 1e-5 / rtol 1e-4, the
  greedy tokens exactly equal;
* the config field for field and the parameter count.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import registry, rwkv6

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
ARCH = "rwkv6-3b"


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def model():
    """The reduced config in both packages and one set of seeded
    weights: numpy leaves moved into the port by ``params_from_jax`` and
    into JAX arrays for the reference, whose serving steps run jitted
    (as its engine runs them; one compile per shape)."""
    cfg, jcfg = reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH))
    tree = _np_tree(registry.init_params(cfg, 3, "cpu"))
    params = params_from_jax(cfg, tree, "cpu")
    steps = (jax.jit(lambda p, b, c: jregistry.apply_prefill(jcfg, p, b, c)),
             jax.jit(lambda p, t, c, pos: jregistry.apply_decode(
                 jcfg, p, t, c, pos)))
    return cfg, jcfg, params, jax.tree.map(jnp.asarray, tree), steps


def test_config_matches_jax_field_for_field():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced(get_config(ARCH)),
                       jax_reduced(jax_get_config(ARCH)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jregistry.param_count(jcfg)
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        assert cfg.is_encoder_decoder == jcfg.is_encoder_decoder
    assert registry.module_for(cfg) is rwkv6


@pytest.mark.parametrize("T", [1, 7])
def test_wkv_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    B, H, hd = 2, 3, 8
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 1.0, (B, T, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    jy, js = jrwkv6._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    ty, ts = rwkv6._wkv_scan(*(torch.from_numpy(a)
                               for a in (r, k, v, w, u, s0)))
    _close(ty, jy, "y")
    _close(ts, js, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal((3, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16)).astype(np.float32)
    jd, td = jnp.dtype(dtype), L.torch_dtype(dtype)
    jy = JL.group_norm_heads(*(jnp.asarray(a).astype(jd) for a in (x, w, b)))
    ty = L.group_norm_heads(*(torch.from_numpy(a).to(td) for a in (x, w, b)))
    assert ty.dtype == td
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("plen", [1, 6, 13])
def test_prefill_then_decode_matches_jax(model, plen):
    cfg, jcfg, params, jparams, (jprefill, jdecode) = model
    rng = np.random.default_rng(plen)
    toks = rng.integers(1, 250, (2, plen)).astype(np.int32)
    jl, jc, _ = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                         jregistry.init_cache(jcfg, 2, 0))
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            registry.init_cache(cfg, 2, 0, device="cpu"))
    _close(tl, jl, "prefill logits")
    for step in range(8):
        for name in ("state", "tm_x", "cm_x"):
            _close(tc[name], jc[name], f"{name} before step {step}")
        tok = np.argmax(np.asarray(jl)[:, -1], -1)
        assert (tl[:, -1].argmax(-1).numpy() == tok).all(), step
        tok = tok[:, None].astype(np.int32)
        pos = np.full((2, 1), plen + step, np.int32)
        jl, jc, _ = jdecode(jparams, jnp.asarray(tok), jc,
                            jnp.asarray(pos))
        with torch.no_grad():
            tl, tc, _ = registry.apply_decode(
                cfg, params, torch.from_numpy(tok).long(), tc,
                torch.from_numpy(pos).long())
        _close(tl, jl, f"decode logits, step {step}")


def test_prefill_without_cache_matches_jax(model):
    """``cache=None`` starts from a zero state, as the reference's."""
    cfg, jcfg, params, jparams, _ = model
    toks = np.random.default_rng(9).integers(1, 250, (1, 5)).astype(np.int32)
    jl, jc, _ = jregistry.apply_prefill(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)}, None)
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()}, None)
    _close(tl, jl, "logits")
    for name in ("state", "tm_x", "cm_x"):
        _close(tc[name], jc[name], name)
