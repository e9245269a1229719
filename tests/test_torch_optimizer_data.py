"""Port parity of the optimizer, the gradient compression, the data
pipeline and the tree helpers (CPU).

* ``optimizer.schedule`` at steps 0, 1, mid-warmup, warmup, mid-decay,
  ``decay_steps`` and beyond, against ``jax.jit`` of the reference's
  (rtol 1e-6: a few fp32 ulps, the two ``cos`` may part by one);
* ``global_norm`` and ``apply_updates`` on a random tree whose dicts are
  not in sorted order (the leaf order is JAX's), fp32 and bf16 params,
  against ``jax.jit`` of the reference's: params, m, v, master, step,
  grad_norm and lr within atol 1e-7 / rtol 1e-5 (bf16 params: one bf16
  ulp);
* ``init_opt_state`` never aliases fp32 params;
* the ports of ``tests/test_distribution_data.py``'s
  ``TestGradCompression`` and ``TestDataPipeline``, and the reference's
  message for an unknown compression mode;
* ``SyntheticLM`` and ``MemorizeLM`` batches byte-equal to the JAX
  package's for several (seed, step), at vocab 256 and 151,936, and
  ``host_slice`` equal to the reference's over a grid of
  (B, count, index);
* ``common.tree``'s leaf order, key paths and ``PyTreeDef`` string equal
  JAX's;
* ``configs.SHAPES`` and ``cell_applicable``, ``registry.input_specs``
  and ``decode_cache_len``, and ``launch.steps.micro_batches`` (on a
  one-device mesh) equal the reference's; ``steps.build_step`` gives the
  train, prefill and decode steps of a shape's kind, the latter two
  equal to the registry's functions.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.distribution.collectives import maybe_compress as jmaybe_compress
from repro.training import optimizer as jopt
from repro_torch.common import tree
from repro_torch.data.pipeline import (DataConfig, Prefetcher, host_slice,
                                       make_source)
from repro_torch.distribution.collectives import maybe_compress
from repro_torch.training import optimizer as opt

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-7, 1e-5


def _close(t, j, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _random_tree(seed, dtype=torch.float32):
    """A nested tree whose dicts are NOT in sorted key order, so a
    port that summed in insertion order would differ."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    t = {"z": {"w": arr(4, 8), "b": arr(8)},
         "a": {"y": arr(3, 5, 2), "c": {"k": arr(7)}},
         "m": arr(16)}
    return tree.tree_map(lambda a: torch.from_numpy(a).to(dtype), t)


def _np(t):
    return tree.tree_map(lambda x: x.float().numpy(), t)


def _jax_tree(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), _np(t))


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("step", [0, 1, 50, 100, 5_050, 10_000, 20_000])
def test_schedule_matches_jax(step):
    cfg, jcfg = opt.OptConfig(), jopt.OptConfig()
    want = jax.jit(lambda s: jopt.schedule(jcfg, s))(jnp.asarray(step,
                                                                 jnp.int32))
    got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0, err_msg=f"lr at step {step}")


def test_global_norm_matches_jax():
    g = _random_tree(1)
    want = jax.jit(jopt.global_norm)(_jax_tree(g))
    _close(opt.global_norm(g), want, "global_norm", atol=0, rtol=1e-6)


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(pdt):
    """Two updates from a random state (the second with the state the
    first left), clipped (grad norm above clip_norm) and past warmup."""
    cfg = opt.OptConfig(warmup_steps=1, decay_steps=10, clip_norm=1.0)
    jcfg = jopt.OptConfig(warmup_steps=1, decay_steps=10, clip_norm=1.0)
    tdt = getattr(torch, pdt)
    params = _random_tree(2, tdt)
    state = opt.init_opt_state(params)
    jstate = jopt.init_opt_state(_jax_tree(params, jnp.dtype(pdt)))
    jstep = jax.jit(lambda g, s: jopt.apply_updates(jcfg, g, s,
                                                    jnp.dtype(pdt)))
    for i in range(2):
        grads = tree.tree_map(lambda x: x * 3.0, _random_tree(10 + i, tdt))
        new_p, state, m = opt.apply_updates(cfg, grads, state, tdt)
        jp, jstate, jm = jstep(_jax_tree(grads, jnp.dtype(pdt)), jstate)
        for k in ("grad_norm", "lr"):
            _close(m[k], jm[k], f"{k} after update {i + 1}", rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for name in ("m", "v", "master"):
            got, paths = tree.flatten_with_paths(state[name])
            for t, j, p in zip(got, jax.tree.leaves(jstate[name]), paths):
                _close(t, j, f"{name}{p} after update {i + 1}")
        ulp = 2.0 ** -7 if pdt == "bfloat16" else 0.0
        got, paths = tree.flatten_with_paths(new_p)
        for t, j, p in zip(got, jax.tree.leaves(jp), paths):
            assert t.dtype == tdt
            _close(t, np.asarray(j, np.float32), f"params{p}",
                   rtol=max(RTOL, ulp))


def test_init_opt_state_never_aliases_fp32_params():
    params = _random_tree(3)
    st = opt.init_opt_state(params)
    for p, w in zip(tree.leaves(params), tree.leaves(st["master"])):
        assert w.dtype == torch.float32
        assert w.data_ptr() != p.data_ptr()
        before = w.clone()
        p.add_(1.0)
        assert torch.equal(w, before), "master moved with the params"
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for name in ("m", "v"):
        assert all(not bool(x.any()) for x in tree.leaves(st[name]))


# ------------------------------------------------------ grad compression
class TestGradCompression:
    def test_bf16_compression_rounds_backward(self):
        p = {"w": torch.full((8,), 1.0, requires_grad=True)}
        q = maybe_compress(p, "bf16")
        (q["w"] * 1.2345678).sum().backward()
        expect = torch.tensor(1.2345678).to(torch.bfloat16).float()
        assert torch.equal(p["w"].grad, expect.expand(8))

    def test_none_is_identity(self):
        p = {"w": torch.ones(4)}
        assert maybe_compress(p, "none") is p
        assert maybe_compress(p, "none")["w"] is p["w"]

    def test_compression_matches_jax_and_spares_other_dtypes(self):
        x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
        jg = jax.grad(lambda w: (jmaybe_compress({"w": w}, "bf16")["w"]
                                 * jnp.asarray(x)).sum())(jnp.ones(64))
        w = torch.ones(64, requires_grad=True)
        (maybe_compress({"w": w}, "bf16")["w"] * torch.from_numpy(x)
         ).sum().backward()
        np.testing.assert_array_equal(w.grad.numpy(), np.asarray(jg))
        wb = torch.ones(64, dtype=torch.bfloat16, requires_grad=True)
        (maybe_compress({"w": wb}, "bf16")["w"].float()
         * torch.from_numpy(x)).sum().backward()
        assert torch.equal(wb.grad, torch.from_numpy(x).to(torch.bfloat16))

    def test_unknown_mode_raises_like_jax(self):
        with pytest.raises(ValueError) as je:
            jmaybe_compress({"w": jnp.ones(2)}, "fp8")
        with pytest.raises(ValueError) as te:
            maybe_compress({"w": torch.ones(2)}, "fp8")
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------- data pipeline
class TestDataPipeline:
    def test_deterministic_across_restart(self):
        cfg = DataConfig(128, 32, 8, seed=5)
        a = make_source(cfg).batch_at(17)
        b = make_source(cfg).batch_at(17)   # fresh instance == restart
        np.testing.assert_array_equal(a, b)

    def test_different_steps_differ(self):
        src = make_source(DataConfig(128, 32, 8, seed=5))
        assert not np.array_equal(src.batch_at(1), src.batch_at(2))

    def test_host_slices_partition(self):
        slices = [host_slice(10, pi, 3) for pi in range(3)]
        rows = sorted(i for s in slices for i in range(s.start, s.stop))
        assert rows == list(range(10))

    def test_prefetcher_ordered_and_sliced(self):
        cfg = DataConfig(64, 16, 6, seed=1)
        src = make_source(cfg)
        with Prefetcher(src, start_step=4, sl=slice(0, 3)) as pf:
            b0 = next(pf)
            b1 = next(pf)
        np.testing.assert_array_equal(b0["tokens"], src.batch_at(4)[:3])
        np.testing.assert_array_equal(b1["tokens"], src.batch_at(5)[:3])

    def test_memorize_cycles(self):
        src = make_source(DataConfig(64, 16, 4, seed=2, kind="memorize"))
        a = src.batch_at(0)
        b = src.batch_at(4)  # 4 batches x 4 rows = one full 16-row cycle
        np.testing.assert_array_equal(a, b)

    def test_synthetic_has_bigram_structure(self):
        cfg = DataConfig(128, 64, 16, seed=9, bigram_rate=0.5)
        src = make_source(cfg)
        toks = src.batch_at(0)
        succ = src._bigram[toks[:, :-1]]
        hit = (toks[:, 1:] == succ).mean()
        assert hit > 0.3   # ~bigram_rate, >> 1/128 chance


@pytest.mark.parametrize("kind", ["synthetic", "memorize"])
@pytest.mark.parametrize("vocab", [256, 151_936])
def test_batches_byte_equal_jax(kind, vocab):
    for seed in (0, 7):
        kw = dict(seed=seed, kind=kind)
        src = make_source(DataConfig(vocab, 48, 4, **kw))
        jsrc = jpipe.make_source(jpipe.DataConfig(vocab, 48, 4, **kw))
        for step in (0, 1, 5, 1_000):
            a, b = src.batch_at(step), jsrc.batch_at(step)
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes(), (kind, vocab, seed, step)


def test_unknown_data_kind_raises_like_jax():
    with pytest.raises(ValueError) as je:
        jpipe.make_source(jpipe.DataConfig(64, 8, 2, kind="corpus"))
    with pytest.raises(ValueError) as te:
        make_source(DataConfig(64, 8, 2, kind="corpus"))
    assert str(te.value) == str(je.value)


def test_host_slice_matches_jax_grid():
    for B in (1, 4, 7, 8, 10, 256):
        for count in (1, 2, 3, 4, 16):
            for index in range(count):
                assert host_slice(B, index, count) == \
                    jpipe.host_slice(B, index, count), (B, count, index)
    # defaults: no process group -> (0, 1), as one JAX process
    assert host_slice(8) == jpipe.host_slice(8) == slice(0, 8)


# ------------------------------------------------------------------ tree
def test_tree_order_paths_and_treedef_match_jax():
    t = {"params": {"z": torch.ones(1), "b": [torch.ones(2),
                                              (torch.ones(3),)]},
         "opt": {"step": torch.zeros((), dtype=torch.int32), "m": None}}
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    leaves, paths = tree.flatten_with_paths(t)
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in jl]
    assert [x.shape for x in leaves] == [tuple(x.shape) for _, x in jl]
    assert tree.treedef_str(t) == str(jax.tree_util.tree_structure(jt))
    back = tree.unflatten(t, leaves)
    assert list(back) == list(t) and list(back["params"]) == ["z", "b"]
    assert all(a is b for a, b in zip(tree.leaves(back), leaves))


# ------------------------------------------- configs, specs, step builders
def test_shapes_and_cell_applicable_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_applicable as jcell
    from repro.configs import get_config as jget
    from repro.configs import list_configs
    from repro_torch.configs import SHAPES, cell_applicable, get_config
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for name in list_configs():
        for sname in SHAPES:
            assert cell_applicable(get_config(name), SHAPES[sname]) == \
                jcell(jget(name), JSHAPES[sname]), (name, sname)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "h2o-danube-1.8b",
                                  "rwkv6-3b", "whisper-large-v3"])
def test_input_specs_and_cache_len_match_jax(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.models import registry as jregistry
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import registry
    cfg, jcfg = get_config(arch), jget(arch)
    for sname, shape in SHAPES.items():
        got = tree.flatten_with_paths(registry.input_specs(cfg, shape))
        want = jax.tree_util.tree_flatten_with_path(
            jregistry.input_specs(jcfg, JSHAPES[sname]))[0]
        assert got[1] == [jax.tree_util.keystr(kp) for kp, _ in want]
        for t, (_, j) in zip(got[0], want):
            assert t.shape == tuple(j.shape)
            assert str(t.dtype)[6:] == str(j.dtype), (arch, sname)
        if shape.kind == "decode":
            assert registry.decode_cache_len(cfg, shape) == \
                jregistry.decode_cache_len(jcfg, JSHAPES[sname])


def test_micro_batches_match_jax():
    from jax.sharding import Mesh
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as jsteps
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    cfg = get_config("qwen2-1.5b")
    for S in (64, 1024, 4096, 32_768):
        for B in (1, 2, 6, 8, 256):
            got = steps.micro_batches(cfg, ShapeConfig("t", S, B, "train"))
            assert got == jsteps.micro_batches(
                cfg, JShape("t", S, B, "train"), mesh), (S, B)
    assert steps.micro_batches(cfg, ShapeConfig("t", 4096, 8, "train")) == 8
    assert steps.micro_batches(cfg, ShapeConfig("t", 64, 8, "train")) == 1


def test_build_step_dispatches_by_kind():
    """``build_step`` gives the train, prefill and decode steps with
    their abstract arguments; the prefill and decode steps run the
    registry's functions (the decode step's next token is the argmax),
    the prefill with no spec, as the reference's step (K/V written into
    the cache as projected, not snapped to the int8 pool)."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import registry
    cfg = reduced(get_config("qwen2-1.5b"))
    built = {k: steps.build_step(cfg, ShapeConfig("t", 16, 2, k))
             for k in ("train", "prefill", "decode")}
    assert {k: b.meta["kind"] for k, b in built.items()} == \
        {k: k for k in built}
    assert built["train"].meta["num_microbatches"] == 1
    p_abs, o_abs, b_abs = built["train"].args
    assert all(t.device.type == "meta" for t in tree.leaves((p_abs, o_abs)))
    assert b_abs["tokens"].shape == (2, 16)
    assert built["decode"].args[1].shape == (2, 1)
    assert tree.leaves(built["decode"].args[2])[0].shape[2] == 16
    params = registry.init_params(cfg, 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)))
    cache = registry.init_cache(cfg, 2, 20, device="cpu")
    ref_cache = registry.init_cache(cfg, 2, 20, device="cpu")
    logits, cache = built["prefill"].fn(params, {"tokens": toks}, cache)
    want, _, _ = registry.apply_prefill(cfg, params, {"tokens": toks},
                                        ref_cache)
    assert torch.equal(logits, want)
    pos = torch.full((2, 1), 16)
    nxt, logits, cache = built["decode"].fn(params, toks[:, -1:], cache, pos)
    want, _, _ = registry.apply_decode(cfg, params, toks[:, -1:], ref_cache,
                                       pos)
    assert torch.equal(logits, want)
    assert nxt.dtype == torch.int32 and torch.equal(
        nxt[:, 0], want[:, -1].argmax(-1).to(torch.int32))
