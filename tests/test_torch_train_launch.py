"""Port parity of the training launcher (``repro_torch.launch.train``) on
reduced qwen2-1.5b (CPU).

* Across the launchers: the port saves its seeded initial state as a
  step-0 checkpoint; JAX's launcher (``repro.launch.train.run``) restores
  it, trains 2 steps and writes its step-2 checkpoint; both launchers
  then resume from that checkpoint for 3 more steps on the same data
  (the pipeline is a function of (seed, step)). Every logged loss agrees
  within atol 1e-5 / rtol 1e-4 (the train-step tests' tolerance), and
  so do the port's 2 steps from the step-0 checkpoint with JAX's.
* The port's run interrupted at a checkpoint and resumed equals its
  uninterrupted run: losses and the final saved state bit for bit (one
  process on the CPU: every sum runs in one order).
* ``retry`` with an injected transient error restores through
  ``on_retry`` (the checkpoint manager's ``restore_or``) and the run
  ends with the uninterrupted run's losses.

whisper through both launchers is ``test_torch_train_whisper.py``'s.
"""
from __future__ import annotations

import logging
import shutil

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.common import tree
from repro_torch.common.transient import TransientError
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
ARCH = "qwen2-1.5b"


class _Losses(logging.Handler):
    """Collects (step, loss) from a launcher's per-step log lines."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.msg.startswith("step "):
            self.steps.append((record.args[0], record.args[1]))


def _run(module, logger, *argv):
    h = _Losses()
    lg = logging.getLogger(logger)
    lg.addHandler(h)
    old = lg.level
    lg.setLevel(logging.INFO)
    try:
        out = module.run(module.build_parser().parse_args(
            ["--arch", ARCH, "--reduced", "--log-every", "1", *argv]))
    finally:
        lg.removeHandler(h)
        lg.setLevel(old)
    return out, h.steps


def _port(*argv):
    return _run(train, "repro_torch.train", "--device", "cpu", *argv)


def _jax(*argv):
    return _run(jtrain, "repro.train", *argv)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.fixture(scope="module")
def init_ckpt(tmp_path_factory):
    """The port's seeded initial state of the launcher (seed 0) saved as
    a step-0 checkpoint."""
    d = tmp_path_factory.mktemp("init")
    params = registry.init_params(reduced(get_config(ARCH)), 0, "cpu")
    ckpt.save_checkpoint(str(d), 0, {"params": params,
                                     "opt": opt.init_opt_state(params)})
    return d


def _close_losses(got, want, what):
    assert [s for s, _ in got] == [s for s, _ in want], what
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               atol=ATOL, rtol=RTOL, err_msg=what)


def test_launchers_resume_a_jax_checkpoint_alike(init_ckpt, tmp_path):
    # JAX's launcher: restore the port's step 0, train 2 steps, save
    ja = _copy(init_ckpt, tmp_path / "jax_first")
    _, jax_first = _jax("--steps", "2", "--checkpoint-dir", ja)
    assert ckpt.latest_step(ja) == 2
    _, port_first = _port("--steps", "2", "--checkpoint-dir",
                          _copy(init_ckpt, tmp_path / "port_first"))
    _close_losses(port_first, jax_first, "2 steps from the step-0 ckpt")
    # both resume from JAX's step-2 checkpoint for 3 more steps
    jb = _copy(ja, tmp_path / "jax_resume")
    pb = _copy(ja, tmp_path / "port_resume")
    jout, jax_resume = _jax("--steps", "3", "--checkpoint-dir", jb)
    pout, port_resume = _port("--steps", "3", "--checkpoint-dir", pb)
    assert [s for s, _ in port_resume] == [2, 3, 4]
    _close_losses(port_resume, jax_resume, "3 steps resumed from step 2")
    assert pout["steps"] == jout["steps"] == 3
    assert ckpt.latest_step(pb) == ckpt.latest_step(jb) == 5


def test_interrupted_run_equals_uninterrupted(init_ckpt, tmp_path):
    full_dir = str(tmp_path / "full")
    part_dir = str(tmp_path / "part")
    _, full = _port("--steps", "5", "--checkpoint-dir", full_dir)
    _, first = _port("--steps", "2", "--checkpoint-dir", part_dir,
                     "--checkpoint-interval", "2")
    out, rest = _port("--steps", "3", "--checkpoint-dir", part_dir)
    assert first + rest == full
    assert out["first_loss"] == full[2][1] and out["last_loss"] == full[4][1]
    built = steps_lib.build_train_step(reduced(get_config(ARCH)),
                                       train.SHAPES["train_4k"])
    like = {"params": built.args[0], "opt": built.args[1]}
    a, sa, _ = ckpt.load_checkpoint(full_dir, like, device="cpu")
    b, sb, _ = ckpt.load_checkpoint(part_dir, like, device="cpu")
    assert sa == sb == 5
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


def test_retry_restores_through_on_retry(tmp_path, monkeypatch):
    _, clean = _port("--steps", "3")
    build = steps_lib.build_train_step
    calls = {"step": 0, "restore": 0}

    def flaky_build(*a, **k):
        built = build(*a, **k)
        fn = built.fn

        def step(*args):
            calls["step"] += 1
            if calls["step"] == 2:
                raise TransientError("collective timeout (injected)")
            return fn(*args)
        built.fn = step
        return built

    restore = ckpt.CheckpointManager.restore_or

    def counting_restore(self, *a, **k):
        calls["restore"] += 1
        return restore(self, *a, **k)

    monkeypatch.setattr(steps_lib, "build_train_step", flaky_build)
    monkeypatch.setattr(ckpt.CheckpointManager, "restore_or",
                        counting_restore)
    out, got = _port("--steps", "3", "--checkpoint-dir",
                     str(tmp_path / "c"), "--checkpoint-interval", "1")
    # one step function call failed and was retried; on_retry restored
    # through the manager once beside the launcher's own restore
    assert calls["step"] == 4 and calls["restore"] == 2
    assert got == clean and out["steps"] == 3
