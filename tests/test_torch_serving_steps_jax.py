"""The port's one-device prefill and decode steps held against the
reference's (``training.train_loop.make_prefill_step`` /
``make_decode_step``), on the same weights, tokens and caches.

For reduced qwen2-1.5b, olmoe-1b-7b and zamba2-7b (the three configs of
``test_torch_mesh_serving_steps.py``, whose mesh steps equal these
one-device steps bit for bit, so these hold the mesh steps against the
reference too), with the shapes and caches of the mesh test
(``launch.steps.build_prefill_step`` / ``build_decode_step`` caches,
zero-filled):

* the prefill of a 16-token prompt into a prefill-shaped cache: logits
  and every cache leaf;
* a prefill into a decode-shaped cache, then one decode step of every
  row at the scalar position 16 (the reference's aligned batch; the port
  spreads it over its per-row positions): next tokens equal, logits and
  every cache leaf close.

Both steps thread no spec: ``registry.apply_prefill`` with no spec
writes K/V into a dense cache as projected, in both packages (only an
explicit int8 or fp8_v spec snaps them to the pool grid). The last test
holds that no-spec call itself against the reference's, on reduced
qwen2-1.5b, where snapping put the prefill logits 1.47 apart.

Tolerances: rtol 1e-4, and atol 1e-5 (the train-step tests') for
qwen2-1.5b (measured at most 1.1e-5 on values up to 2.3, within the
rtol); 5e-5 for olmoe-1b-7b (measured 2.5e-5: a K element of 0.014
after the first MoE layer, whose routed sums round apart); 5e-4 for
zamba2-7b (measured 2.35e-4 in the tail's SSD state and 2.06e-4 in the
logits: a Mamba2 layer amplifies fp32 rounding about 10x on random
weights, ``test_torch_zamba2.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import registry as jregistry
from repro.training import train_loop as jtrain_loop
from repro_torch.common import tree
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.training.train_loop import make_decode_step, make_prefill_step

from test_torch_rwkv6 import _np_tree

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
MODEL_ATOL = {"olmoe-1b-7b": 5e-5, "zamba2-7b": 5e-4}
B, S_PROMPT, S_DECODE = 4, 16, 32
PREFILL = ShapeConfig("p", S_PROMPT, B, "prefill")
DECODE = ShapeConfig("d", S_DECODE, B, "decode")


def _zeros(kind, cfg):
    built = (steps.build_prefill_step if kind == "prefill"
             else steps.build_decode_step)(cfg, PREFILL if kind == "prefill"
                                           else DECODE)
    return tree.tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype),
                         built.args[2])


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(t, j, what, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               atol=atol, rtol=RTOL, err_msg=what)


def _close_cache(tc, jc, what, atol):
    jl = jax.tree_util.tree_leaves_with_path(jc)
    got, paths = tree.flatten_with_paths(tc)
    assert paths == [jax.tree_util.keystr(p) for p, _ in jl], what
    for t, (p, j) in zip(got, jl):
        _close(t, j, f"{what}{jax.tree_util.keystr(p)}", atol)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "zamba2-7b"])
def test_prefill_and_decode_steps_match_jax(arch):
    cfg = reduced(get_config(arch))
    jcfg = jax_reduced(jax_get_config(arch))
    atol = MODEL_ATOL.get(arch, ATOL)
    np_params = _np_tree(registry.init_params(cfg, 3, "cpu"))
    params = params_from_jax(cfg, np_params, "cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    jprefill = jax.jit(jtrain_loop.make_prefill_step(jcfg))
    jdecode = jax.jit(jtrain_loop.make_decode_step(jcfg))
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    toks = _tokens(cfg, (B, S_PROMPT), 1)

    def both_prefill(kind):
        cache = _zeros(kind, cfg)
        jl, jc = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                          jax.tree.map(jnp.asarray, _np_tree(cache)))
        with torch.no_grad():
            tl, tc = prefill(params, {"tokens": torch.from_numpy(toks)},
                             cache)
        return (tl, tc), (jl, jc)

    (tl, tc), (jl, jc) = both_prefill("prefill")
    _close(tl, jl, f"{arch} prefill logits", atol)
    _close_cache(tc, jc, f"{arch} prefill cache", atol)

    (_, tc), (_, jc) = both_prefill("decode")
    _close_cache(tc, jc, f"{arch} prefill into the decode cache", atol)
    tok = _tokens(cfg, (B, 1), 2)
    jn, jl, jc = jdecode(jparams, jnp.asarray(tok), jc,
                         jnp.asarray(S_PROMPT, jnp.int32))
    with torch.no_grad():
        tn, tl, tc = decode(params, torch.from_numpy(tok), tc,
                            torch.tensor(S_PROMPT, dtype=torch.int32))
    assert tn.dtype == torch.int32 and tn.shape == (B, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close(tl, jl, f"{arch} decode logits", atol)
    _close_cache(tc, jc, f"{arch} decode cache", atol)


def test_no_spec_prefill_matches_jax_no_spec():
    """``registry.apply_prefill(cfg, params, batch, cache)`` with no spec
    against the reference's no-spec call: reduced qwen2-1.5b, B 4, S 16,
    weights from seed 3, into a zero-filled prefill cache."""
    cfg = reduced(get_config("qwen2-1.5b"))
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    np_params = _np_tree(registry.init_params(cfg, 3, "cpu"))
    params = params_from_jax(cfg, np_params, "cpu")
    toks = _tokens(cfg, (B, S_PROMPT), 1)
    cache = _zeros("prefill", cfg)
    jl, jc, _ = jregistry.apply_prefill(
        jcfg, jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(toks)},
        jax.tree.map(jnp.asarray, _np_tree(cache)))
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(tl, jl, "no-spec prefill logits", ATOL)
    _close_cache(tc, jc, "no-spec prefill cache", ATOL)
