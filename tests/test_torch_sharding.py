"""The port's logical-axis sharding rules and meshes against the
reference's.

``TestSpecFor`` ports ``tests/test_distribution_data.py``'s five tests
on the port's own ``Mesh``. ``test_spec_for_matches_reference`` and
``test_zero1_matches_reference`` hold ``spec_for`` and ``zero1_spec``
spec for spec against the reference's on ``jax.sharding.AbstractMesh``es
of the production shapes (16, 16) and (2, 16, 16) and of a (1, 4) host
mesh (no device needed), over a fixed list of logical axes and shapes:
the experts/mlp dedup, dims the axis does not divide, axes the mesh
lacks, both rule sets and an explicit physical tuple. The meshes'
shapes, and ``make_serving_mesh``'s errors without a process group.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import Mesh, PartitionSpec as P
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     make_serving_mesh)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def _mesh():
    # a (1, 1) mesh exercises the rule resolution logic
    return Mesh((("data", 1), ("model", 1)))


class TestSpecFor:
    def test_dedup_first_wins(self):
        """MoE (experts, embed, mlp): experts and mlp both map to model;
        the first dim keeps it (pure EP), later dims drop it."""
        mesh = _mesh()
        spec = shd.spec_for(("experts", "embed", "mlp"), (64, 128, 256),
                            mesh, shd.RULES_TP)
        assert spec == P("model", None, None)

    def test_non_divisible_dropped(self):
        mesh = _mesh()
        rules = dict(shd.RULES_TP)
        spec = shd.spec_for(("vocab",), (7,), mesh, rules)  # 7 % 1 == 0
        assert spec == P("model")
        # fake a bigger axis via rules onto a missing mesh axis
        spec2 = shd.spec_for(("heads",), (6,), mesh,
                             dict(rules, heads="nope"))
        assert spec2 == P(None)

    def test_missing_axis_is_none(self):
        mesh = _mesh()  # no "pod" axis
        spec = shd.spec_for(("batch", None), (8, 4), mesh, shd.RULES_TP)
        assert spec == P("data", None)  # ("pod","data") -> present subset

    def test_zero1_adds_data_axis(self):
        mesh = _mesh()
        spec = shd.zero1_spec(("embed", "mlp"), (128, 256), mesh,
                              shd.RULES_TP)
        parts = list(spec) + [None] * (2 - len(spec))
        assert any(p is not None and "data" in (
            p if isinstance(p, tuple) else (p,)) for p in parts)

    def test_shard_activation_noop_outside_ctx(self):
        x = torch.ones((4, 4))
        y = shd.shard_activation(x, "batch", None)
        assert y is x


#: (logical axes, shape) pairs: weights, activations, MoE stacks, dims
#: the axes do not divide, axes a mesh lacks, an explicit physical tuple
CASES = [
    (("experts", "embed", "mlp"), (64, 128, 256)),
    (("experts", "mlp", "embed"), (64, 1024, 2048)),
    (("embed", "mlp"), (1536, 8960)),
    (("mlp", "embed"), (8960, 1536)),
    (("vocab", "table_embed"), (151936, 1536)),
    (("embed", "heads", "head_dim"), (1536, 12, 128)),
    (("embed", "kv_heads", "head_dim"), (1536, 2, 128)),
    (("heads", "head_dim", "embed"), (12, 128, 1536)),
    (("batch", "seq_act", "embed_act"), (8, 4096, 1536)),
    (("batch", "seq_act", "vocab_act"), (32, 128, 151936)),
    (("batch", None), (8, 4)),
    (("batch", None), (64, 4)),
    (("layers", "embed", "mlp"), (28, 1536, 8960)),
    (("vocab",), (7,)),
    (("heads", "kv_heads"), (16, 16)),
    ((("data", "model"), None), (256, 3)),
    ((None, "experts_act", "mlp_act"), (4, 64, 512)),
    (("state", "conv", "groups"), (64, 4, 8)),
    (("embed",), (4096,)),
    (("kv_seq", "kv_heads"), (1024, 8)),
]

MESHES = [(16, 16), (2, 16, 16), (1, 4)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


@pytest.fixture(scope="module")
def ref():
    from jax.sharding import AbstractMesh
    from repro.distribution import sharding as jshd
    return jshd, {s: AbstractMesh(s, _names(s)) for s in MESHES}


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("rules", ["RULES_TP", "RULES_FSDP_TP"])
def test_spec_for_matches_reference(ref, mshape, rules):
    jshd, meshes = ref
    mesh = Mesh(tuple(zip(_names(mshape), mshape)))
    for logical, shape in CASES:
        got = shd.spec_for(logical, shape, mesh, getattr(shd, rules))
        want = jshd.spec_for(logical, shape, meshes[mshape],
                             getattr(jshd, rules))
        assert tuple(got) == tuple(want), (logical, shape)


@pytest.mark.parametrize("mshape", MESHES)
def test_zero1_matches_reference(ref, mshape):
    jshd, meshes = ref
    mesh = Mesh(tuple(zip(_names(mshape), mshape)))
    for rules in ("RULES_TP", "RULES_FSDP_TP"):
        for logical, shape in CASES:
            got = shd.zero1_spec(logical, shape, mesh, getattr(shd, rules))
            want = jshd.zero1_spec(logical, shape, meshes[mshape],
                                   getattr(jshd, rules))
            assert tuple(got) == tuple(want), (rules, logical, shape)


def test_rules_context_and_tree_specs():
    mesh = Mesh((("data", 2), ("model", 4)))
    assert shd.active_mesh() is None
    with shd.logical_axis_rules(mesh, shd.RULES_TP):
        assert shd.active_mesh() is mesh
        assert shd.spec_for(("embed", "mlp"), (16, 32)) == P(None, "model")
        x = torch.ones(4, 4)
        assert shd.shard_activation(x, "batch") is x
    assert shd.active_mesh() is None
    assert shd.spec_for(("embed", "mlp"), (16, 32)) == P()
    params = {"w": torch.zeros(16, 32), "blk": {"b": torch.zeros(8)}}
    specs = shd.tree_specs(params, {"w": ("embed", "mlp"),
                                    "blk": {"b": ("vocab",)}},
                           mesh, shd.RULES_TP)
    assert specs == {"w": P(None, "model"), "blk": {"b": P("model")}}


def test_production_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.axis_names == ("data", "model") and m.model_group is None
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model")


def test_serving_mesh_without_process_group():
    # one rank: a (1, 1) mesh serves unsharded; more raises with the
    # launch to use
    m = make_serving_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert make_host_mesh(4).shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="needs 2 ranks, have 1 — "
                       "launch with torchrun --nproc-per-node 2"):
        make_serving_mesh(tp=2)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_serving_mesh(tp=2, dp=2)
    with pytest.raises(ValueError):
        make_serving_mesh(tp=0)
