"""Port parity of checkpointing and fault tolerance (CPU).

* The ports of all 12 tests of ``tests/test_checkpoint_fault.py`` on
  ``repro_torch.training``: the elastic reshard restores onto a
  ``device`` (the port has no mesh), and the straggler test drives
  ``StepTimer`` with a patched clock instead of ten 2 ms sleeps (the
  reference's version is a timing flake, ROADMAP.md section 3), and the
  watchdog test advances a patched clock instead of sleeping against a
  0.15 s timeout (a late wake-up no longer breaks it);
* the file format across packages: a checkpoint written by JAX's
  ``save_checkpoint`` (fp32 and bf16 leaves, an int32 step) restores in
  the port bit for bit, an fp32 one written by the port restores in
  JAX's ``load_checkpoint`` bit for bit, and both write the same
  manifest (paths, tree structure, shapes, dtypes);
* the reference fault pinned: JAX's loader raises on a bf16 leaf (numpy
  holds it as ``|V2``), while the port restores the same file exactly;
* ``convert.opt_state_from_jax`` of the reference's optimizer state.
"""
from __future__ import annotations

import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro_torch.common import tree
from repro_torch.models.registry import ShapeDtype
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import fault

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(4, 8)),
                                     dtype=torch.float32),
                   "b": torch.tensor(rng.normal(size=(8,)),
                                     dtype=torch.float32)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "m": {"w": torch.zeros((4, 8)), "b": torch.ones((8,))}},
    }


def _specs(s):
    return tree.tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype), s)


def _equal_bits(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        s = _state()
        ckpt.save_checkpoint(str(tmp_path), 10, s, meta={"loss": 1.5})
        out, step, meta = ckpt.load_checkpoint(str(tmp_path), _specs(s),
                                               device="cpu")
        assert step == 10 and meta["loss"] == 1.5
        for a, b in zip(tree.leaves(s), tree.leaves(out)):
            _equal_bits(a, b)

    def test_latest_and_retention(self, tmp_path):
        for step in (1, 2, 3, 4):
            ckpt.save_checkpoint(str(tmp_path), step, _state(step), keep=2)
        assert ckpt.latest_step(str(tmp_path)) == 4
        kept = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("step_"))
        assert len(kept) == 2

    def test_structure_mismatch_rejected(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), 1, _state())
        bad = {"params": {"w": ShapeDtype((4, 8), torch.float32)}}
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(str(tmp_path), bad, device="cpu")

    def test_shape_mismatch_rejected(self, tmp_path):
        s = _state()
        ckpt.save_checkpoint(str(tmp_path), 1, s)
        like = _specs(s)
        like["params"]["w"] = ShapeDtype((5, 8), torch.float32)
        with pytest.raises(ValueError):
            ckpt.load_checkpoint(str(tmp_path), like, device="cpu")

    def test_elastic_reshard_onto_device(self, tmp_path):
        """Leaves stored as full logical arrays restore wherever the
        caller runs: onto an explicit device, onto the devices of a
        ``like`` tree of tensors, and not onto a stand-in without one."""
        s = _state()
        ckpt.save_checkpoint(str(tmp_path), 2, s)
        out, step, _ = ckpt.load_checkpoint(
            str(tmp_path), tree.tree_map(lambda x: x.to("meta"), s),
            device=torch.device("cpu"))
        assert step == 2
        assert all(x.device.type == "cpu" for x in tree.leaves(out))
        out2, _, _ = ckpt.load_checkpoint(
            str(tmp_path), tree.tree_map(torch.zeros_like, s))
        for a, b in zip(tree.leaves(s), tree.leaves(out2)):
            _equal_bits(a, b)
        with pytest.raises(ValueError, match="device"):
            ckpt.load_checkpoint(str(tmp_path), _specs(s))

    def test_manager_restore_or_init(self, tmp_path):
        mgr = ckpt.CheckpointManager(str(tmp_path), interval=2, keep=2)
        like = _specs(_state())
        st0, step0, _ = mgr.restore_or(like, _state, device="cpu")
        assert step0 == 0
        assert mgr.maybe_save(1, st0) is None      # not on interval
        assert mgr.maybe_save(2, st0) is not None  # on interval
        _, step1, _ = mgr.restore_or(like, _state, device="cpu")
        assert step1 == 2

    def test_atomic_no_partial_dirs(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), 5, _state())
        entries = os.listdir(tmp_path)
        assert not [e for e in entries if ".tmp" in e]
        man = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
        assert man["n_leaves"] == len(tree.leaves(_state()))


class _Clock:
    """A stand-in for ``time.perf_counter`` that advances only when told."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class TestFault:
    def test_step_timer_flags_straggler(self, monkeypatch):
        clock = _Clock()
        # the fault module's clock only (a stand-in for its ``time``)
        monkeypatch.setattr(fault, "time", types.SimpleNamespace(
            perf_counter=clock, monotonic=time.monotonic, sleep=time.sleep))
        t = fault.StepTimer(window=20, threshold=2.0, warmup=0)
        for i in range(10):
            t.start()
            clock.t += 0.002
            t.stop(i)
        t.start()
        clock.t += 0.05  # 25x median
        t.stop(10)
        assert len(t.events) == 1
        assert t.events[0].slowdown > 2.0
        assert t.summary()["stragglers"] == 1

    def test_watchdog_fires_and_beats(self, monkeypatch):
        clock = _Clock()
        # the fault module's clock only: the watchdog reads time.monotonic
        monkeypatch.setattr(fault, "time", types.SimpleNamespace(
            perf_counter=time.perf_counter, monotonic=clock,
            sleep=time.sleep))
        fired = threading.Event()
        with fault.Watchdog(0.15, fired.set, poll_s=0.001) as wd:
            for _ in range(5):   # heartbeats keep it quiet
                clock.t += 0.05
                # polls of the thread at this clock do not fire
                assert not fired.wait(timeout=0.02)
                wd.beat()
            assert not wd.fired
            clock.t += 0.3       # silence -> fire
            assert fired.wait(timeout=30.0)
        assert fired.is_set() and wd.fired

    def test_retry_recovers_with_hook(self):
        calls = {"n": 0, "restored": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("collective timeout")
            return x + 1

        out = fault.retry(flaky, 41, retries=3, backoff_s=0.01,
                          on_retry=lambda a, e: calls.__setitem__(
                              "restored", calls["restored"] + 1))
        assert out == 42 and calls["restored"] == 2

    def test_retry_exhausts(self):
        def dead(_):
            raise RuntimeError("down")
        with pytest.raises(RuntimeError):
            fault.retry(dead, 0, retries=1, backoff_s=0.01)

    def test_elastic_mesh_shape(self):
        assert fault.elastic_mesh_shape(256, 16) == (16, 16)
        assert fault.elastic_mesh_shape(240, 16) == (15, 16)   # lost a host
        assert fault.elastic_mesh_shape(512, 16, pod=2) == (2, 16, 16)
        with pytest.raises(ValueError):
            fault.elastic_mesh_shape(8, 16)


# --------------------------------------------------- across the packages
def _mixed_jax_state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.normal(size=(4, 8)), jnp.bfloat16),
                   "b": jnp.asarray(rng.normal(size=(8,)), jnp.float32)},
        "opt": {"step": jnp.asarray(7, jnp.int32),
                "master": {"w": jnp.asarray(rng.normal(size=(4, 8)),
                                            jnp.float32),
                           "b": jnp.asarray(rng.normal(size=(8,)),
                                            jnp.float32)}},
    }


def _torch_of(jt):
    """A JAX tree as the port's tensors (bf16 through its bits)."""
    def one(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {k: _torch_of(v) if isinstance(v, dict) else one(v)
            for k, v in jt.items()}


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    js = _mixed_jax_state()
    jckpt.save_checkpoint(str(tmp_path), 12, js, meta={"loss": 2.0})
    want = _torch_of(js)
    out, step, meta = ckpt.load_checkpoint(str(tmp_path), _specs(want),
                                           device="cpu")
    assert step == 12 and meta == {"loss": 2.0}
    for a, b in zip(tree.leaves(want), tree.leaves(out)):
        _equal_bits(a, b)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert out["opt"]["step"].dtype == torch.int32


def test_port_fp32_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    s = _state(4)
    ckpt.save_checkpoint(str(tmp_path), 3, s, meta={"loss": 0.5})
    jlike = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(tuple(x.shape),
                                       jnp.dtype(str(x.dtype)[6:])), s)
    out, step, meta = jckpt.load_checkpoint(str(tmp_path), jlike)
    assert step == 3 and meta == {"loss": 0.5}
    for a, b in zip(tree.leaves(s), jax.tree.leaves(out)):
        b = np.asarray(b)
        assert b.dtype == a.numpy().dtype
        assert a.numpy().tobytes() == b.tobytes()


def test_manifests_agree_across_packages(tmp_path):
    js = _mixed_jax_state(1)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, _torch_of(js))
    man = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json"))
           for d in ("jax", "port")]
    for k in ("format", "step", "process_count", "n_leaves", "treedef",
              "paths", "leaves", "meta"):
        assert man[0][k] == man[1][k], k
    # the shard files hold the same leaves byte for byte (bf16 as |V2)
    zj = np.load(tmp_path / "jax" / "step_00000001" / "shard_00000.npz")
    zp = np.load(tmp_path / "port" / "step_00000001" / "shard_00000.npz")
    assert sorted(zj.files) == sorted(zp.files)
    for f in zj.files:
        assert zj[f].dtype == zp[f].dtype and \
            zj[f].tobytes() == zp[f].tobytes(), f


def test_reference_fault_bf16_restore(tmp_path):
    """The JAX loader cannot restore its own bf16 leaf (a |V2 array has
    no cast to bfloat16); the port views the bits and restores it."""
    w = jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 1, {"w": w})
    with pytest.raises(ValueError, match="cast"):
        jckpt.load_checkpoint(
            str(tmp_path), {"w": jax.ShapeDtypeStruct((3,), jnp.bfloat16)})
    out, _, _ = ckpt.load_checkpoint(
        str(tmp_path), {"w": ShapeDtype((3,), torch.bfloat16)}, device="cpu")
    _equal_bits(out["w"], _torch_of({"w": w})["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_state_from_jax_matches_port_init(dtype):
    """``convert.opt_state_from_jax`` of the reference's
    ``init_opt_state`` equals the port's of the same params bit for
    bit: fp32 m, v and master (master an fp32 copy of bf16 params too),
    the step a 0-d int32 tensor; a malformed step raises."""
    from repro.training import optimizer as jopt
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype=dtype)
    tree_np = tree.tree_map(lambda t: t.numpy(),
                            registry.init_params(cfg.replace(
                                dtype="float32"), 2, "cpu"))
    params = params_from_jax(cfg, tree_np, "cpu")
    jo = jopt.init_opt_state(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree_np))
    got = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jo), "cpu")
    want = opt.init_opt_state(params)
    assert list(got) == list(want)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        _equal_bits(a, b)
    bad = dict(jax.tree.map(np.asarray, jo), step=np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="step"):
        opt_state_from_jax(cfg, bad, "cpu")
