"""Port parity of the train step on the recurrent and encoder-decoder
families (CPU): reduced rwkv6-3b here, whisper-large-v3 in
``test_torch_train_whisper.py`` and zamba2-7b in
``test_torch_train_zamba2.py`` (each file under 30 s on one worker).

The same seeded weights (the port's, moved as numpy through
``params_from_jax``) and batches through ``jax.jit`` of the JAX
package's functions and the port's: ``lm_loss`` and every gradient leaf
against ``jax.value_and_grad``, then three train steps at two
microbatches against the jitted reference step (loss, grad_norm, lr,
then params, m, v, master and step). whisper's batch holds ``frames``
of the shape ``registry.input_specs`` gives a train cell (B, S_enc,
d_model) beside tokens of S_enc / 8.

Tolerances: the gradients, m and v at atol 1e-5 / rtol 1e-4 plus a
share of the leaf's largest value (``SCALE``), the grad norm at
``NORM_RTOL``; params and master at 0.1 x the peak lr (the train-step
file's; zamba2's at the peak lr, ``P_ATOL``). rwkv6's bonus ``u`` sums B x T outer products of the WKV state
through the scan and reaches |g| ~ 16, where fp32 sums in another order
part by ~1e-5 of it (measured 9.8e-6); it dominates the grad norm (~40),
which after the first update parts by 1.5e-4 relative (measured). A
Mamba2 layer amplifies fp32 rounding ~10x on random weights (ROADMAP.md
section 3): zamba2's gradients part by up to 6e-4 of a leaf's largest
(measured, the first group's conv and projections), its grad norm by
2.3e-4 after two updates, and so a parameter whose gradient lies within
that rounding may take one update the other way (4.9e-5 measured). whisper needs no extra tolerance.
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
from repro_torch.common import tree
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop as tl

from test_torch_train_step import ATOL, PARAM_ATOL, RTOL, _np_tree

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

#: extra tolerance of the gradients, m and v, as a share of the leaf's
#: largest value, and the grad norm's rtol
SCALE = {"rwkv6-3b": 1e-4, "zamba2-7b": 2e-3, "whisper-large-v3": 0.0}
NORM_RTOL = {"rwkv6-3b": 5e-4, "zamba2-7b": 1e-3, "whisper-large-v3": RTOL}
#: params and master: zamba2's at one update's size (the peak lr: an
#: element whose gradient lies within that rounding may step the other
#: way), the others at the train-step file's 0.1 x the peak lr
P_ATOL = {"rwkv6-3b": PARAM_ATOL, "zamba2-7b": 10 * PARAM_ATOL,
          "whisper-large-v3": PARAM_ATOL}


def _batch(cfg, seed, B=4, S=24):
    """numpy inputs of a train cell: tokens [B,S] (and whisper's frames
    [B,S,D] with tokens [B,S/8], the shapes ``input_specs`` gives)."""
    rng = np.random.default_rng(seed)
    specs = registry.input_specs(cfg, ShapeConfig("t", S, B, "train"))
    out = {}
    for k, sd in specs["batch"].items():
        if k == "tokens":
            out[k] = rng.integers(0, cfg.vocab_size,
                                  size=sd.shape).astype(np.int32)
        else:
            out[k] = rng.standard_normal(sd.shape).astype(np.float32)
    return out


def _model(arch):
    cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    return cfg, jcfg, _np_tree(registry.init_params(cfg, 3, "cpu"))


def _grad_close(t, j, what, scale):
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t, j, rtol=RTOL,
                               atol=ATOL + scale * np.abs(j).max(),
                               err_msg=what)


def check_family(arch, *, nm=2, S=24):
    """lm_loss and every gradient, then three train steps at ``nm``
    microbatches, against the jitted reference."""
    scale, norm_rtol = SCALE[arch], NORM_RTOL[arch]
    cfg, jcfg, tree_np = _model(arch)
    b = _batch(cfg, 0, S=S)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jtl.lm_loss(jcfg, p, x), has_aux=True))(
            jax.tree.map(jnp.asarray, tree_np), jax.tree.map(jnp.asarray, b))
    params = params_from_jax(cfg, tree_np, "cpu")
    loss, grads = tl._value_and_grad(
        cfg, params, tree.tree_map(torch.from_numpy, b), "none")
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    got, paths = tree.flatten_with_paths(grads)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in jleaves]
    for t, (_, j), p in zip(got, jleaves, paths):
        _grad_close(t, j, f"{arch} grad{p}", scale)

    ocfg = dict(warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.OptConfig(**ocfg),
                                        num_microbatches=nm))
    step = tl.make_train_step(cfg, opt.OptConfig(**ocfg),
                              num_microbatches=nm)
    jp = jax.tree.map(jnp.asarray, tree_np)
    jo = jopt.init_opt_state(jp)
    state = opt.init_opt_state(params)
    for i in range(3):
        b = _batch(cfg, 100 + i, S=S)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        params, state, m = step(params, state,
                                tree.tree_map(torch.from_numpy, b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=ATOL, rtol=RTOL, err_msg=f"loss at {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_rtol,
                                   err_msg=f"grad_norm at {i}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["step"]) == int(jo["step"]) == 3
    for name, got_t, want in (("params", params, jp),
                              ("master", state["master"], jo["master"])):
        leaves, paths = tree.flatten_with_paths(got_t)
        for t, j, p in zip(leaves, jax.tree.leaves(want), paths):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       atol=P_ATOL[arch], rtol=RTOL,
                                       err_msg=f"{arch} {name}{p}")
    for name in ("m", "v"):
        leaves, paths = tree.flatten_with_paths(state[name])
        for t, j, p in zip(leaves, jax.tree.leaves(jo[name]), paths):
            _grad_close(t, j, f"{arch} {name}{p}", scale)


def test_rwkv6_loss_grads_and_steps_match_jax():
    check_family("rwkv6-3b")


def test_whisper_batch_takes_input_specs_shapes():
    cfg = reduced(get_config("whisper-large-v3"))
    b = _batch(cfg, 0, B=2, S=64)
    assert b["frames"].shape == (2, 64, cfg.d_model)
    assert b["tokens"].shape == (2, 8)
    # the launcher passes tokens only, and whisper's train step reads
    # frames: the same KeyError as the reference's apply_train
    params = params_from_jax(cfg, _np_tree(registry.init_params(cfg, 3,
                                                                "cpu")),
                             "cpu")
    with pytest.raises(KeyError, match="frames"):
        tl.lm_loss(cfg, params, {"tokens": torch.from_numpy(b["tokens"])})
