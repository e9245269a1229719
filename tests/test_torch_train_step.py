"""Port parity of the train step on reduced qwen2-1.5b (CPU).

The same seeded weights (the port's, moved as numpy through ``params_from_jax``)
and token batches through the JAX package's functions under ``jax.jit``
(as its launcher runs them) and the port's:

* ``lm_loss`` and the gradient of every leaf against
  ``jax.value_and_grad`` of the reference's (atol 1e-5, rtol 1e-4);
* three train steps against three jitted reference ``train_step``s with
  ``OptConfig(warmup_steps=1)`` (updates at the peak rate): loss,
  grad_norm and lr after each step, then params, m, v, master and step
  (params and master at atol 3e-5 = 0.1 x the peak lr: Adam's
  normalized direction m/sqrt(v) turns a gradient's last-bit rounding
  into a visible step where |g| is near eps; m and v at the gradients'
  atol 1e-5 / rtol 1e-4);
* ``num_microbatches`` 1, 2 and 4, and 3 on a batch of 6 (1/3 is not
  exact: the port multiplies by the reciprocal, as XLA compiles the
  reference's division);
* remat on equal to remat off in the port, bit for bit;
* ``hdp.apply_in_training=True``: the trainable call resolves to
  ``xla_hdp`` in both packages, and the loss and every gradient (through
  the scout's calibration max; the gradients of round, trunc and the
  integer casts are zero in both) equal JAX's at atol 1e-5, rtol 1e-4.

The window and MoE families are in ``test_torch_train_window_moe.py``;
the bf16 gradient compression, bf16 accumulators and a bf16 model in
``test_torch_train_variants.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.attention import registry as jattn_registry
from repro.models import attention as jattention
from repro_torch.attention import registry as attn_registry
from repro_torch.common import tree
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, registry
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop as tl

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
#: params and master after Adam updates: 0.1 x the peak learning rate
PARAM_ATOL = 0.1 * opt.OptConfig().peak_lr
S = 24


def _np_tree(t):
    return tree.tree_map(lambda x: x.detach().numpy(), t)


def _close(t, j, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _tokens(seed, B, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, S)).astype(np.int32)


def _model(arch, **over):
    cfg = reduced(get_config(arch)).replace(**over)
    jcfg = jax_reduced(jax_get_config(arch)).replace(**over)
    return cfg, jcfg, _np_tree(registry.init_params(cfg, 3, "cpu"))


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2-1.5b")


def check_grads(cfg, jcfg, tree_np, toks, atol=ATOL, rtol=RTOL):
    """lm_loss and every gradient leaf against jax.value_and_grad."""
    jb = {"tokens": jnp.asarray(toks)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtl.lm_loss(jcfg, p, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree_np), jb)
    params = params_from_jax(cfg, tree_np, "cpu")
    loss, aux = tl.lm_loss(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(loss, jl, "loss")
    _close(aux["aux_loss"], jaux["aux_loss"], "aux_loss")
    l2, grads = tl._value_and_grad(cfg, params,
                                   {"tokens": torch.from_numpy(toks)}, "none")
    assert torch.equal(l2, loss.detach())
    got, paths = tree.flatten_with_paths(grads)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in jleaves]
    for t, (_, j), p in zip(got, jleaves, paths):
        _close(t, j, f"grad{p}", atol, rtol)
    return float(loss)


def check_steps(cfg, jcfg, tree_np, *, nm=1, B=4, comp="none",
                accum="float32", m_atol=ATOL, m_rtol=RTOL, n=3):
    """``n`` port train steps against ``n`` jitted reference steps."""
    ocfg = dict(warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jopt.OptConfig(**ocfg), num_microbatches=nm,
        grad_compression=comp, accum_dtype=jnp.dtype(accum)))
    step = tl.make_train_step(cfg, opt.OptConfig(**ocfg),
                              num_microbatches=nm, grad_compression=comp,
                              accum_dtype=getattr(torch, accum))
    jp = jax.tree.map(jnp.asarray, tree_np)
    jo = jopt.init_opt_state(jp)
    params = params_from_jax(cfg, tree_np, "cpu")
    state = opt.init_opt_state(params)
    for i in range(n):
        toks = _tokens(100 + i, B)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(toks)})
        _close(m["loss"], jm["loss"], f"loss at step {i}")
        _close(m["grad_norm"], jm["grad_norm"], f"grad_norm at step {i}",
               rtol=1e-5 if comp == "none" and accum == "float32" else RTOL)
        _close(m["lr"], jm["lr"], f"lr at step {i}", atol=0, rtol=1e-6)
    assert int(state["step"]) == int(jo["step"]) == n
    assert state["step"].dtype == torch.int32
    for name, got, want, atol, rtol in (
            ("params", params, jp, PARAM_ATOL, RTOL),
            ("master", state["master"], jo["master"], PARAM_ATOL, RTOL),
            ("m", state["m"], jo["m"], m_atol, m_rtol),
            ("v", state["v"], jo["v"], m_atol, m_rtol)):
        leaves, paths = tree.flatten_with_paths(got)
        for t, j, p in zip(leaves, jax.tree.leaves(want), paths):
            if name == "params":
                assert t.dtype == getattr(torch, cfg.dtype)
            _close(t, j, f"{name}{p} after {n} steps", atol, rtol)
    return params, state


def test_qwen2_loss_and_grads_match_jax(qwen):
    check_grads(*qwen, _tokens(0, 4))


@pytest.mark.parametrize("nm,B", [(1, 4), (2, 4), (4, 4), (3, 6)])
def test_qwen2_steps_match_jax(qwen, nm, B):
    check_steps(*qwen, nm=nm, B=B)


def test_remat_equals_no_remat_bit_for_bit(qwen):
    """``cfg.remat`` (off in every reduced config) recomputes each layer
    in the backward pass and changes no bit of the loss, the gradients
    or the updated state; on a microbatched step too."""
    cfg, _, tree_np = qwen
    outs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        params = params_from_jax(c, tree_np, "cpu")
        step = tl.make_train_step(c, opt.OptConfig(warmup_steps=1),
                                  num_microbatches=2)
        outs.append(step(params, opt.init_opt_state(params),
                         {"tokens": torch.from_numpy(_tokens(5, 4))}))
    (p0, o0, m0), (p1, o1, m1) = outs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(tree.leaves((p0, o0)), tree.leaves((p1, o1))):
        assert torch.equal(a, b)


def test_hdp_in_training_grads_match_jax(qwen):
    cfg, jcfg, tree_np = qwen
    cfg = cfg.replace(hdp=cfg.hdp.replace(apply_in_training=True))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(apply_in_training=True))
    call = attention.build_attn_call(cfg, mode="train", self_aligned=True)
    jcall = jattention.build_attn_call(jcfg, mode="train",
                                       self_aligned=True)
    assert attn_registry.resolve_backend(call).name == \
        jattn_registry.resolve_backend(jcall).name == "xla_hdp"
    toks = _tokens(1, 4)
    loss = check_grads(cfg, jcfg, tree_np, toks)
    # the HDP path moved the loss: it is not the dense one
    params = params_from_jax(cfg, tree_np, "cpu")
    dense = tl.lm_loss(qwen[0], params, {"tokens": torch.from_numpy(toks)})
    assert float(dense[0]) != loss
