"""The dry run (``launch/dryrun.py``): every cell traced per shard on the
production meshes, on the CPU, against the reference's dry-run contract.

* ``run_cell`` on reduced configs, registered for the test (the full
  widths' sweep is a command-line run, ``PERF.md``), is ``ok`` for the
  train, prefill and decode kinds on both production meshes (whisper's
  encoder-decoder on the 16x16 one), with the reference's record keys
  (``trace_s`` in the place of ``compile_s``);
* its skips and their reasons are the reference's ``cell_applicable``;
* ``main()`` writes the JSON, ``--append`` skips the cells already
  ``ok``, and a cell that fails is recorded with its error and makes the
  exit code 1;
* rank 0 stands for every rank: its record equals the last rank's on a
  traced (2, 2) mesh, and ``traced_mesh`` numbers ranks as
  ``make_training_mesh`` does;
* ``argument_bytes`` is the sum of the rank's argument shards (the batch
  whole: every rank of a mesh step takes the global batch).
"""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_config as jax_get_config
from repro_torch.common import tree
from repro_torch.configs import (SHAPES, ShapeConfig, cell_applicable,
                                 get_config, list_configs, reduced)
from repro_torch.configs import base
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import Mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, traced_mesh

torch.set_num_threads(1)

TINY = {"tiny_train": ShapeConfig("tiny_train", 16, 32, "train"),
        "tiny_prefill": ShapeConfig("tiny_prefill", 16, 32, "prefill"),
        "tiny_decode": ShapeConfig("tiny_decode", 16, 32, "decode")}
KEYS = {"arch", "shape", "mesh", "status", "trace_s", "n_devices",
        "num_microbatches", "memory", "roofline", "fits_hbm"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_bytes"}


@pytest.fixture
def tiny(monkeypatch):
    """Reduced configs registered as ``<arch>-reduced`` and the TINY
    shapes in ``SHAPES``, both undone after the test."""
    for arch in ("qwen2-1.5b", "whisper-large-v3"):
        cfg = reduced(get_config(arch)).replace(name=arch + "-reduced")
        monkeypatch.setitem(base._REGISTRY, cfg.name,
                            lambda cfg=cfg: cfg)
    for name, shape in TINY.items():
        monkeypatch.setitem(SHAPES, name, shape)


@pytest.mark.parametrize("arch,meshes", [("qwen2-1.5b", (False, True)),
                                         ("whisper-large-v3", (False,))])
def test_run_cell_reduced_ok_on_both_meshes(tiny, arch, meshes):
    for multi in meshes:
        for name in TINY:
            rec = dryrun.run_cell(arch + "-reduced", name, multi_pod=multi,
                                  verbose=False)
            assert rec["status"] == "ok", rec.get("traceback")
            assert set(rec) == KEYS and set(rec["memory"]) == MEMORY
            assert rec["mesh"] == ("2x16x16" if multi else "16x16")
            assert rec["n_devices"] == (512 if multi else 256)
            r = rec["roofline"]
            assert r["flops"] > 0 and r["bytes_accessed"] > 0
            assert r["hw"] == "h100_sxm" and rec["fits_hbm"]
            assert r["coll_by_kind"].get("all-gather", 0) > 0
            m = rec["memory"]
            assert m["peak_bytes"] == m["argument_bytes"] + \
                m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]


def test_skip_reasons_equal_reference():
    for name in list_configs():
        cfg, jcfg = get_config(name), jax_get_config(name)
        for shape in SHAPES:
            ok, reason = cell_applicable(cfg, SHAPES[shape])
            assert (ok, reason) == jax_cell_applicable(jcfg, JSHAPES[shape])
            if not ok:
                rec = dryrun.run_cell(name, shape, multi_pod=True,
                                      verbose=False)
                assert rec == {"arch": name, "shape": shape,
                               "mesh": "2x16x16", "status": "skip",
                               "reason": reason}


def test_main_writes_appends_and_fails(tiny, tmp_path, monkeypatch):
    out = str(tmp_path / "sub" / "dry.json")
    argv = ["--arch", "qwen2-1.5b-reduced", "--mesh", "single", "--out", out]
    assert dryrun.main(argv + ["--shape", "tiny_decode"]) == 0
    recs = json.loads(open(out).read())
    assert [(r["shape"], r["status"]) for r in recs] == [("tiny_decode",
                                                          "ok")]
    calls = []
    real = dryrun.run_cell

    def counted(arch, shape, **kw):
        calls.append(shape)
        return real(arch, shape, **kw)

    monkeypatch.setattr(dryrun, "run_cell", counted)
    assert dryrun.main(argv + ["--shape", "tiny_decode", "--append"]) == 0
    assert calls == [] and json.loads(open(out).read()) == recs

    def broken(*a, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    assert dryrun.main(argv + ["--shape", "tiny_prefill", "--append"]) == 1
    recs = json.loads(open(out).read())
    assert [(r["shape"], r["status"]) for r in recs] == [
        ("tiny_decode", "ok"), ("tiny_prefill", "fail")]
    assert recs[1]["error"] == "RuntimeError: injected"
    assert "injected" in recs[1]["traceback"]


def test_traced_mesh_numbers_ranks_like_the_training_mesh():
    mesh = make_production_mesh(multi_pod=True)
    assert traced_mesh(mesh, 0).coords == {"pod": 0, "data": 0, "model": 0}
    assert traced_mesh(mesh, 511).coords == {"pod": 1, "data": 15,
                                             "model": 15}
    assert traced_mesh(mesh, 17).coords == {"pod": 0, "data": 1, "model": 1}
    t = traced_mesh(Mesh((("data", 2), ("model", 2))), 3)
    assert t.traced and t.groups is None and t.coords == {"data": 1,
                                                          "model": 1}
    with pytest.raises(ValueError):
        traced_mesh(mesh, 512)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_rank0_record_equals_last_rank(kind):
    cfg = reduced(get_config("qwen2-1.5b"))
    shape = ShapeConfig("t", 16, 8, kind)
    mesh = Mesh((("data", 2), ("model", 2)))
    recs = []
    for rank in (0, 3):
        built, traced = dryrun.trace_cell(cfg, shape, mesh, rank=rank)
        recs.append(dryrun.record(cfg, shape, 4, built, traced))
    assert recs[0] == recs[1]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_are_the_shards(kind):
    cfg = reduced(get_config("olmoe-1b-7b"))
    shape = ShapeConfig("t", 16, 8, kind)
    mesh = Mesh((("data", 2), ("model", 2)))
    built, traced = dryrun.trace_cell(cfg, shape, mesh)
    on = traced_mesh(mesh, 0)
    whole = 2 if kind == "train" else 1
    sizes = []
    for i, (arg, specs) in enumerate(zip(built.args, built.in_specs)):
        if i == whole or specs is None:
            sizes += [math.prod(x.shape) * x.dtype.itemsize
                      for x in tree.leaves(arg)]
        else:
            shd.map_specs(lambda x, s: sizes.append(math.prod(
                shd.local_shape(x.shape, s, on)) * x.dtype.itemsize),
                arg, specs)
    want = sum(sizes)
    assert traced.memory["argument_bytes"] == want
    assert want < sum(math.prod(x.shape) * x.dtype.itemsize
                      for x in tree.leaves(built.args))
