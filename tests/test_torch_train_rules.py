"""The port's sharding rules and spec trees against the reference's, with
no process: every function here is pure in a config and a mesh shape.

The reference's functions run on ``jax.sharding.AbstractMesh``es (no
device needed) of the production shapes (16, 16) and (2, 16, 16) and of
the small meshes (1, 2), (2, 1), (2, 2) and (1, 4); the port's on its own
``Mesh`` of the same shape. For every registered config, all exact:

* ``steps.choose_rules`` dict for dict, for the kinds train, prefill and
  decode and ``fsdp`` None, True and False;
* ``registry.param_specs`` leaf for leaf (JAX's sorted flatten) at full
  size, the meta tensors of ``registry.abstract_params`` shape for shape
  and dtype for dtype, and ``registry.param_count``;
* the param, ZeRO-1 and batch ``PartitionSpec``s of
  ``build_train_step`` against JAX's ``spec_for`` and ``zero1_spec``
  composed with its ``param_specs`` under its ``choose_rules``, and the
  cache specs of the prefill and decode builders against the same
  composition over ``registry.cache_specs``;
* ``steps.micro_batches`` on every ``SHAPES`` entry;
* a shard's place in its tensor: ``local_slice`` over the coordinates of
  a (pod, data, model) mesh tiles the tensor major to minor, and a step
  on the abstract production mesh, or ``launch.train --mesh single``,
  raises and names the dry run (``python -m repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import list_configs
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import Mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

CONFIGS = list_configs()
MESHES = [(16, 16), (2, 16, 16), (1, 2), (2, 1), (2, 2), (1, 4)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _mesh(shape) -> Mesh:
    return Mesh(tuple(zip(_names(shape), shape)))


@functools.lru_cache(maxsize=None)
def _amesh(shape):
    from jax.sharding import AbstractMesh
    return AbstractMesh(shape, _names(shape))


@functools.lru_cache(maxsize=None)
def _jax_abstract(name):
    from repro.models import registry as jreg
    return jreg.abstract_params(jax_get_config(name))


def _walk(tree, path=""):
    """(path, leaf) in JAX's order; tuples (logical axes, PartitionSpecs)
    and tensors are leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + f"[{k!r}]")
    else:
        yield path, tree


def _jax_walk(tree):
    import jax
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return [(jax.tree_util.keystr(k), v) for k, v in flat]


def _jax_specs(abs_tree, logical, amesh, rules, zero1=False):
    """JAX's ``spec_for`` / ``zero1_spec`` over a (shapes, logical axes)
    tree pair: [(path, spec as a tuple)]."""
    import jax
    from repro.distribution import sharding as jshd
    fn = jshd.zero1_spec if zero1 else jshd.spec_for
    tree = jax.tree.map(lambda x, ax: tuple(fn(tuple(ax), x.shape, amesh,
                                               rules)),
                        abs_tree, logical)
    return _jax_walk(tree)


def _port(tree):
    return [(p, tuple(s)) for p, s in _walk(tree)]


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_choose_rules_match_reference(name, mshape):
    from repro.launch import steps as jsteps
    cfg, jcfg = get_config(name), jax_get_config(name)
    for kind in ("train", "prefill", "decode"):
        for fsdp in (None, True, False):
            got = steps.choose_rules(cfg, kind, _mesh(mshape), fsdp=fsdp)
            want = jsteps.choose_rules(jcfg, kind, _amesh(mshape),
                                       fsdp=fsdp)
            assert got == want, (kind, fsdp)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_and_count_match_reference(name):
    from repro.models import registry as jreg
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert registry.param_count(cfg) == jreg.param_count(jcfg)
    assert registry.param_count(cfg, active_only=True) == \
        jreg.param_count(jcfg, active_only=True)
    got = list(_walk(registry.param_specs(cfg)))
    assert got == _jax_walk(jreg.param_specs(jcfg))
    j_abs, j_specs = _jax_abstract(name)
    p_abs, p_specs = registry.abstract_params(cfg)
    assert p_specs == registry.param_specs(cfg)
    shapes = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""),
               t.device.type) for p, t in _walk(p_abs)]
    assert shapes == [(p, tuple(x.shape), str(x.dtype), "meta")
                      for p, x in _jax_walk(j_abs)]


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_specs_match_reference(name, mshape):
    from repro.launch import steps as jsteps
    from repro.models import registry as jreg
    from repro.distribution import sharding as jshd
    cfg, jcfg = get_config(name), jax_get_config(name)
    amesh = _amesh(mshape)
    built = steps.build_train_step(cfg, SHAPES["train_4k"], _mesh(mshape))
    rules = jsteps.choose_rules(jcfg, "train", amesh)
    assert built.rules == rules
    assert built.meta["num_microbatches"] == jsteps.micro_batches(
        jcfg, JSHAPES["train_4k"], amesh)
    p_sh, o_sh, b_sh = built.in_specs
    j_abs, j_specs = _jax_abstract(name)
    assert _port(p_sh) == _jax_specs(j_abs, j_specs, amesh, rules)
    want_z = _jax_specs(j_abs, j_specs, amesh, rules, zero1=True)
    for k in ("m", "v", "master"):
        assert _port(o_sh[k]) == want_z, k
    assert tuple(o_sh["step"]) == ()
    batch = jreg.input_specs(jcfg, JSHAPES["train_4k"])["batch"]
    assert {k: tuple(v) for k, v in b_sh.items()} == {
        k: tuple(jshd.spec_for(("batch",) + (None,) * (len(x.shape) - 1),
                               x.shape, amesh, rules))
        for k, x in batch.items()}


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_serving_step_specs_match_reference(name, mshape):
    from repro.launch import steps as jsteps
    from repro.models import registry as jreg
    cfg, jcfg = get_config(name), jax_get_config(name)
    amesh = _amesh(mshape)
    j_abs, j_specs = _jax_abstract(name)
    for kind, shape in (("prefill", "prefill_32k"), ("decode", "decode_32k")):
        build = getattr(steps, f"build_{kind}_step")
        built = build(cfg, SHAPES[shape], _mesh(mshape))
        rules = jsteps.choose_rules(jcfg, kind, amesh)
        assert built.rules == rules, kind
        cache = jsteps._cache_abs(jcfg, JSHAPES[shape], kind)
        assert _port(built.in_specs[0]) == _jax_specs(j_abs, j_specs, amesh,
                                                      rules), kind
        assert _port(built.in_specs[2]) == _jax_specs(
            cache, jreg.cache_specs(jcfg), amesh, rules), kind
        assert [tuple(t.shape) for _, t in _walk(built.args[2])] == [
            tuple(x.shape) for _, x in _jax_walk(cache)], kind


@pytest.mark.parametrize("sname", sorted(SHAPES))
def test_micro_batches_match_reference(sname):
    from repro.launch import steps as jsteps
    cfg, jcfg = get_config("qwen2-1.5b"), jax_get_config("qwen2-1.5b")
    for mshape in MESHES:
        for B in (None, 1, 3, 8, 48):
            shape, jshape = SHAPES[sname], JSHAPES[sname]
            if B is not None:
                shape = ShapeConfig(sname, shape.seq_len, B, shape.kind)
                jshape = type(jshape)(sname, jshape.seq_len, B, jshape.kind)
            assert steps.micro_batches(cfg, shape, _mesh(mshape)) == \
                jsteps.micro_batches(jcfg, jshape, _amesh(mshape)), \
                (mshape, B)


def test_local_slices_tile_major_to_minor():
    """Every coordinate's ``local_slice`` of a dim split over ("pod",
    "data") and another over "model" is the block at the coordinates'
    mixed-radix index, pod-major, so the shards tile the tensor."""
    sizes = (("pod", 2), ("data", 3), ("model", 2))
    x = torch.arange(12 * 4 * 5).reshape(12, 4, 5)
    spec = shd.PartitionSpec(("pod", "data"), "model", None)
    seen = torch.zeros_like(x)
    for pod in range(2):
        for data in range(3):
            for model in range(2):
                mesh = Mesh(sizes, coords={"pod": pod, "data": data,
                                           "model": model})
                assert shd.shard_index(mesh, ("pod", "data")) == \
                    (pod * 3 + data, 6)
                part = shd.local_slice(x, spec, mesh)
                assert tuple(part.shape) == shd.local_shape(
                    x.shape, spec, mesh) == (2, 2, 5)
                i = pod * 3 + data
                assert torch.equal(part, x[2 * i:2 * i + 2,
                                           2 * model:2 * model + 2])
                seen[2 * i:2 * i + 2, 2 * model:2 * model + 2] += 1
    assert bool((seen == 1).all())
    one = Mesh(sizes, coords={"pod": 0, "data": 0, "model": 0})
    with pytest.raises(ValueError, match="cannot reshard"):
        shd.reshard(x, shd.PartitionSpec("model"),
                    shd.PartitionSpec("data"), one)


def test_production_mesh_steps_raise_naming_the_dry_run():
    """Specs resolve on the abstract production mesh; running a step on
    it raises and names the dry run, which traces it per shard."""
    cfg = get_config("qwen2-1.5b")
    mesh = make_production_mesh()
    built = steps.build_train_step(cfg, SHAPES["train_4k"], mesh)
    assert tuple(built.in_specs[0]["embed"]["tok"]) == ("model", None)
    dry = "repro_torch.launch.dryrun"
    with pytest.raises(NotImplementedError, match=dry):
        built.fn(*built.args)
    for kind, shape in (("prefill", "prefill_32k"), ("decode", "decode_32k")):
        b = steps.build_step(cfg, SHAPES[shape], mesh)
        assert b.meta["kind"] == kind
        with pytest.raises(NotImplementedError, match=dry):
            b.fn(*b.args)
    from repro_torch.launch import train
    for m in ("single", "multi"):
        args = train.build_parser().parse_args(
            ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
             "--mesh", m, "--steps", "1"])
        with pytest.raises(NotImplementedError, match=dry):
            train.run(args)


def test_one_device_builders_keep_their_callers():
    """``mesh=None`` is one device: the specs resolve on a (1, 1) mesh and
    the train step is the unsharded one, equal to ``make_train_step``'s
    without shardings."""
    from repro_torch.common import tree
    from repro_torch.configs import reduced
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg = reduced(get_config("qwen2-1.5b"))
    built = steps.build_train_step(cfg, ShapeConfig("t", 16, 4, "train"),
                                   num_microbatches=2)
    assert built.rules == steps.choose_rules(cfg, "train", None)
    assert tuple(built.in_specs[2]["tokens"]) == ("data", None)
    params = registry.init_params(cfg, 2, "cpu")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 16)).astype(np.int32))}
    got = built.fn(params, opt.init_opt_state(params), toks)
    want = make_train_step(cfg, opt.OptConfig(), num_microbatches=2)(
        params, opt.init_opt_state(params), toks)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(a, b)
