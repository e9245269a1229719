"""Port parity of the examples' substrate (``examples_torch/common.py``).

The same inputs go through the JAX package's helpers
(``benchmarks.common``, ``benchmarks.head_pruning``) and the port's
copies, on ``bench-tiny``'s JAX initial weights (``PRNGKey(7)``, as the
reference's ``train_model`` draws them) moved across with
``params_from_jax``, and on the held-out batches, which are numpy from a
seed:

* ``model_cfg`` field for field, ``eval_batches`` byte for byte;
* ``forward_with_attention``'s logits at atol 1e-5, rtol 1e-4 with dense
  attention and with the sweep's ``hdp_attention`` at one point, and
  equal to the port's ``registry.apply_train`` at the same limits;
  ``capture_qkv``'s q, k and v at the same limits;
* ``theta_head_samples`` at rtol 1e-6, and ``agreement_with`` exactly.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks.head_pruning import theta_head_samples as jtheta  # noqa: E402
from examples_torch import common  # noqa: E402
from repro.core.config import HDPConfig as JHDPConfig  # noqa: E402
from repro.core import hdp as jhdp  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.config import HDPConfig  # noqa: E402
from repro_torch.core.hdp import (dense_attention_reference,  # noqa: E402
                                  hdp_attention)
from repro_torch.models import registry  # noqa: E402

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
#: the sweep's configuration at one of its points (rho 0.3, tau_h at the
#: 15th percentile of the observed theta_head)
SWEEP = dict(block_q=2, block_k=2, approx=True, causal=True,
             head_pruning=True, tau_h=-1.0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jcommon.model_cfg("tiny")
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = common.model_cfg("tiny")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, params, jcfg, jparams, common.eval_batches(1, batch=2)


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _dense(li, q, k, v):
    return dense_attention_reference(q, k, v, causal=True)


def _jdense(li, q, k, v):
    return jhdp.dense_attention_reference(q, k, v, causal=True)


def _hdp_fns(tau):
    cfg = HDPConfig(**SWEEP).replace(rho_b=0.3, tau_h=tau)
    jcfg = JHDPConfig(**SWEEP).replace(rho_b=0.3, tau_h=tau)
    return (lambda li, q, k, v: hdp_attention(q, k, v, cfg)[0],
            lambda li, q, k, v: jhdp.hdp_attention(q, k, v, jcfg)[0])


@pytest.mark.parametrize("scale", ["tiny", "base"])
def test_model_cfg_equals_jax(scale):
    assert dataclasses.asdict(common.model_cfg(scale)) == \
        dataclasses.asdict(jcommon.model_cfg(scale))
    assert (common.SEQ, common.VOCAB) == (jcommon.SEQ, jcommon.VOCAB)


def test_eval_batches_byte_equal():
    got, want = common.eval_batches(), jcommon.eval_batches()
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_forward_dense_equals_jax_and_apply_train(tiny):
    cfg, params, jcfg, jparams, (toks,) = tiny
    got = common.forward_with_attention(cfg, params, toks, _dense)
    want = jcommon.forward_with_attention(jcfg, jparams, toks, _jdense)
    _close(got, want, "logits vs JAX")
    model, _ = registry.apply_train(cfg, params,
                                    {"tokens": torch.from_numpy(toks)})
    _close(got, model.numpy(), "logits vs apply_train")


def test_forward_hdp_equals_jax(tiny):
    cfg, params, jcfg, jparams, batches = tiny
    th = jtheta(jcfg, jparams, batches,
                JHDPConfig(**SWEEP).replace(rho_b=0.3, block_pruning=False))
    fn, jfn = _hdp_fns(float(np.percentile(th, 15)))
    got = common.forward_with_attention(cfg, params, batches[0], fn)
    want = jcommon.forward_with_attention(jcfg, jparams, batches[0], jfn)
    _close(got, want, "HDP logits vs JAX")


def test_capture_qkv_equals_jax(tiny):
    cfg, params, jcfg, jparams, (toks,) = tiny
    got = common.capture_qkv(cfg, params, toks)
    want = jcommon.capture_qkv(jcfg, jparams, toks)
    assert len(got) == len(want) == cfg.n_layers
    for li, (g, w) in enumerate(zip(got, want)):
        for key in ("q", "k", "v"):
            assert tuple(g[key].shape) == (2, cfg.n_heads, common.SEQ,
                                           cfg.hd)
            _close(g[key], w[key], f"layer {li} {key}")


def test_theta_head_samples_and_agreement_equal_jax(tiny):
    cfg, params, jcfg, jparams, batches = tiny
    hdp = HDPConfig(**SWEEP).replace(rho_b=0.3, block_pruning=False)
    got = common.theta_head_samples(cfg, params, batches, hdp)
    want = jtheta(jcfg, jparams, batches,
                  JHDPConfig(**SWEEP).replace(rho_b=0.3, block_pruning=False))
    assert got.shape == want.shape == (cfg.n_layers * 2 * cfg.n_heads,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    fn, jfn = _hdp_fns(float(np.percentile(want, 15)))
    ag = common.agreement_with(cfg, params, fn, batches)
    jag = jcommon.agreement_with(jcfg, jparams, jfn, batches)
    assert ag == jag
    assert common.agreement_with(cfg, params, _dense, batches) == 1.0
