"""Port parity of the examples' training loop and its cache
(``examples_torch/common.py``: ``_fit``, ``train_model``).

* Three steps of the port's loop from ``bench-tiny``'s JAX initial
  weights (``PRNGKey(7)``, moved across with ``params_from_jax``) at
  batch 4, against the reference's loop as ``benchmarks.common.
  train_model`` runs it (``jax.jit(make_train_step)`` with the same
  ``OptConfig`` and the same synthetic batches): every loss at atol
  1e-5, rtol 1e-4, the parameters after the third step within 0.1 x the
  peak learning rate (PERF.md section 2: Adam's normalized step turns a
  gradient's last-bit rounding into a visible step where |g| is near
  eps).
* The cache: a run writes ``torch_tiny_s3.npz`` under ``CACHE_DIR``;
  a second call reads it back bit-equal; a JAX-named ``tiny_s3.npz``
  beside it, holding other arrays, is never opened.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from examples_torch import common  # noqa: E402
from repro.data.pipeline import DataConfig, make_source  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402
from repro_torch.common import tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
PEAK_LR = 1e-3          # the examples' OptConfig
STEPS, BATCH = 3, 4


def _jax_fit(jcfg, params, steps, batch):
    """The loop of the reference's ``train_model``, from ``params``."""
    src = make_source(DataConfig(jcommon.VOCAB, jcommon.SEQ, batch, seed=3,
                                 kind="synthetic"))
    ocfg = jopt.OptConfig(peak_lr=PEAK_LR, warmup_steps=20,
                          decay_steps=steps)
    step_fn = jax.jit(make_train_step(jcfg, ocfg))
    state = jopt.init_opt_state(params)
    losses = []
    for s in range(steps):
        params, state, m = step_fn(params, state,
                                   {"tokens": src.batch_at(s)})
        losses.append(float(m["loss"]))
    return params, losses


def test_three_steps_equal_jax():
    jcfg = jcommon.model_cfg("tiny")
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = common.model_cfg("tiny")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    got, losses = common._fit(cfg, params, STEPS, BATCH, verbose=False)
    want, jlosses = _jax_fit(jcfg, jparams, STEPS, BATCH)
    np.testing.assert_allclose(losses, jlosses, atol=ATOL, rtol=RTOL)
    assert losses[-1] < losses[0]
    leaves, paths = tree.flatten_with_paths(got)
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in jleaves]
    for t, (_, j), p in zip(leaves, jleaves, paths):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=0.1 * PEAK_LR, rtol=0, err_msg=p)


def test_cache_written_reloaded_and_jax_file_never_read(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(common, "CACHE_DIR", str(tmp_path))
    # the reference's name for the same scale and steps, other arrays
    jax_file = tmp_path / "tiny_s3.npz"
    np.savez(jax_file, p0=np.zeros(3, np.float32))
    opened = []
    load = np.load

    def spy(path, *a, **kw):
        opened.append(os.path.basename(str(path)))
        return load(path, *a, **kw)

    monkeypatch.setattr(np, "load", spy)
    cfg, first = common.train_model("tiny", steps=STEPS, batch=2,
                                    verbose=False, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["tiny_s3.npz",
                                            "torch_tiny_s3.npz"]
    assert opened == []
    _, again = common.train_model("tiny", steps=STEPS, batch=2,
                                  verbose=False, device="cpu")
    assert opened == ["torch_tiny_s3.npz"]
    a, pa = tree.flatten_with_paths(first)
    b, pb = tree.flatten_with_paths(again)
    assert pa == pb
    for x, y, p in zip(a, b, pa):
        assert x.dtype == y.dtype and torch.equal(x, y), p
    with load(tmp_path / "torch_tiny_s3.npz") as z:
        assert sorted(z.files) == sorted(pa)
    # the reference's file is as it was written
    with load(jax_file) as z:
        assert z.files == ["p0"]


def test_cache_of_another_config_refused(tmp_path, monkeypatch):
    """A port-named file whose leaves are not the config's raises."""
    monkeypatch.setattr(common, "CACHE_DIR", str(tmp_path))
    np.savez(tmp_path / "torch_base_s3.npz", p0=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="bench-base"):
        common.train_model("base", steps=STEPS, device="cpu")


def test_train_model_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.train_model("tiny", steps=STEPS)


def test_training_batches_equal_jax():
    """The loop's batches are the reference's, byte for byte."""
    from repro_torch.data.pipeline import DataConfig as TDataConfig
    from repro_torch.data.pipeline import make_source as tmake_source
    a = make_source(DataConfig(jcommon.VOCAB, jcommon.SEQ, BATCH, seed=3))
    b = tmake_source(TDataConfig(common.VOCAB, common.SEQ, BATCH, seed=3))
    for s in range(STEPS):
        assert a.batch_at(s).tobytes() == b.batch_at(s).tobytes()
