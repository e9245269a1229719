"""Port parity of the train step's variants on reduced qwen2-1.5b (CPU).

The same seeded weights and batches through ``jax.jit`` of the JAX
package's functions and through the port's, with the helpers and base
tolerances of ``test_torch_train_step.py``:

* ``grad_compression="bf16"``: every gradient leaf within one bf16 ulp
  of JAX's (a value near a bf16 rounding boundary may round to either
  neighbour after fp32 sums in another order), or within 1e-6 where the
  gradient is so small that that fp32 rounding exceeds its bf16 spacing;
  three train steps (m and v at atol 1e-5 plus one bf16 ulp relative,
  for the same reason);
* ``accum_dtype=bfloat16`` with two microbatches, three steps at the
  base tolerances;
* a bf16 model: the loss within 1e-3 relative and each gradient leaf
  within a relative (Frobenius) error of 5e-2 of JAX's bf16 gradients,
  and at most twice as far from them as JAX's own bf16 gradients are
  from its fp32 ones (bf16 rounds each op to 8 bits, and XLA fuses other
  ops than torch runs, so the two round at other places: two runs that
  round independently lie about sqrt(2) times as far apart as each lies
  from the exact value).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.distribution.collectives import maybe_compress as jmaybe_compress
from repro.training import train_loop as jtl
from repro_torch.common import tree
from repro_torch.convert import params_from_jax
from repro_torch.training import train_loop as tl

from test_torch_train_step import (  # noqa: F401  (qwen: a fixture)
    RTOL, _close, _tokens, check_steps, qwen)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8          # bf16 spacing relative to a value, at most


def _jax_value_and_grad(jcfg, jparams, toks, comp="none"):
    def loss(p, b):
        return jtl.lm_loss(jcfg, jmaybe_compress(p, comp), b)
    (jl, _), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams, {"tokens": jnp.asarray(toks)})
    return jl, jg


def _pairs(grads, jg):
    leaves, paths = tree.flatten_with_paths(grads)
    jl = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in jl]
    return [(t.float().numpy(), np.asarray(j, np.float32), p)
            for t, (_, j), p in zip(leaves, jl, paths)]


def test_bf16_compressed_grads_within_one_ulp(qwen):
    cfg, jcfg, tree_np = qwen
    toks = _tokens(0, 4)
    jl, jg = _jax_value_and_grad(jcfg, jax.tree.map(jnp.asarray, tree_np),
                                 toks, "bf16")
    loss, grads = tl._value_and_grad(cfg, params_from_jax(cfg, tree_np,
                                                          "cpu"),
                                     {"tokens": torch.from_numpy(toks)},
                                     "bf16")
    _close(loss, jl, "loss")
    for t, j, p in _pairs(grads, jg):
        # every compressed gradient is a bf16 value in both packages
        assert np.array_equal(t, torch.from_numpy(t).bfloat16().float()), p
        mag = np.maximum(np.abs(t), np.abs(j))
        ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
        bad = np.abs(t - j) > np.maximum(ulp, 1e-6)
        assert not bad.any(), (p, t[bad][:4], j[bad][:4])


def test_bf16_compression_steps_match_jax(qwen):
    check_steps(*qwen, comp="bf16", m_rtol=RTOL + BF16_ULP)


def test_bf16_accumulators_match_jax(qwen):
    check_steps(*qwen, nm=2, accum="bfloat16")


def test_bf16_model_grads_within_bf16_rounding(qwen):
    cfg, jcfg, tree_np = qwen
    toks = _tokens(2, 4)
    j32l, j32 = _jax_value_and_grad(jcfg, jax.tree.map(jnp.asarray, tree_np),
                                    toks)
    cfg16, jcfg16 = cfg.replace(dtype="bfloat16"), \
        jcfg.replace(dtype="bfloat16")
    j16l, j16 = _jax_value_and_grad(
        jcfg16, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                             tree_np), toks)
    params = params_from_jax(cfg16, tree_np, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree.leaves(params))
    loss, grads = tl._value_and_grad(cfg16, params,
                                     {"tokens": torch.from_numpy(toks)},
                                     "none")
    np.testing.assert_allclose(float(loss), float(j16l), rtol=1e-3)
    assert all(g.dtype == torch.bfloat16 for g in tree.leaves(grads))
    for (t, j, p), (_, j_32, _) in zip(_pairs(grads, j16), _pairs(grads,
                                                                    j32)):
        port = np.linalg.norm(t - j) / np.linalg.norm(j)
        own = np.linalg.norm(j - j_32) / np.linalg.norm(j_32)
        assert port <= 5e-2 and port <= 2 * own, (p, port, own)
