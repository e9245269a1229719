"""The prefill and decode steps on a mesh, and the dry run's collective
count held against what the steps send, in gloo worlds (reduced
configs, CPU).

One ``LocalWorld(2)`` for the module (``repro_torch.launch.local_world``),
run at (data 2, model 1) and at (data 1, model 2); the world of four
ranks at (2, 2) is ``test_torch_mesh_serving_steps_tp4.py``. Every rank
builds ``build_prefill_step``,
``build_decode_step`` and ``build_train_step`` on
``make_training_mesh(model=...)`` and holds its shards of the seeded
params and caches (``shard_state``):

* for reduced qwen2-1.5b, olmoe-1b-7b and zamba2-7b (a cache of Mamba2
  states beside the shared block's K/V), each rank's prefill logits,
  decode next tokens and logits and its shard of each new cache equal
  the one-device steps' rows and slices bit for bit (fp32; HDP's
  calibration scale is the whole batch's, ``collectives.group_max``). A
  rank holds 4 or 8 of the batch's 8 rows: at 2 rows the CPU's GEMM for
  the tied logits takes another kernel, whose sums round apart in the
  last bit (3.6e-7 at 2 of 4 rows), so 8 rows keep the comparison exact;
* for reduced qwen2-1.5b, the collective bytes by kind that each step
  records while it runs (count mode: ``sharding.recording``) equal, byte
  for byte, what the dry run records tracing the same step for the same
  rank on a traced mesh of the world's shape (``launch.dryrun``), which
  sends nothing.

Rank functions are module-level and this file imports no jax.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distribution.sharding import Mesh
from repro_torch.launch.local_world import LocalWorld

torch.set_num_threads(1)

ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "zamba2-7b")
B, S_PROMPT, S_DECODE, M = 8, 16, 32, 2
PREFILL = ShapeConfig("p", S_PROMPT, B, "prefill")
DECODE = ShapeConfig("d", S_DECODE, B, "decode")
TRAIN = ShapeConfig("t", S_PROMPT, B, "train")


def _zeros(tree_abs):
    from repro_torch.common import tree
    return tree.tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype),
                         tree_abs)


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                            .astype(np.int32))


def one_device(cfg, params):
    """The one-device steps: a prefill of the prompt into a prefill-shaped
    cache, and (from a prefill into a decode-shaped cache) one decode
    step of every row at position S_PROMPT."""
    from repro_torch.launch import steps
    from repro_torch.training.train_loop import (make_decode_step,
                                                 make_prefill_step)
    toks = _tokens(cfg, (B, S_PROMPT), 1)
    pre = steps.build_prefill_step(cfg, PREFILL)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks},
                                           _zeros(pre.args[2]))
    dec = steps.build_decode_step(cfg, DECODE)
    _, filled = make_prefill_step(cfg)(params, {"tokens": toks},
                                       _zeros(dec.args[2]))
    tok = _tokens(cfg, (B, 1), 2)
    pos = torch.tensor(S_PROMPT, dtype=torch.int32)
    from repro_torch.common import tree
    start = tree.tree_map(lambda x: x.clone(), filled)
    nxt, dlogits, dcache = make_decode_step(cfg)(params, tok, filled, pos)
    return {"toks": toks, "logits": logits, "cache": cache, "tok": tok,
            "pos": pos, "decode_start": start, "next": nxt,
            "dlogits": dlogits, "dcache": dcache}


def serve_rank(model: int):
    """One rank: every arch's mesh prefill and decode against the
    one-device steps, and reduced qwen2-1.5b's collective bytes by kind
    for the prefill, decode and train steps."""
    from repro_torch.common import tree
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import local_rows, shard_state
    mesh = make_training_mesh(model=model)
    rows = torch.tensor(local_rows(mesh, B, 1))
    equal, counts = {}, {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        params = registry.init_params(cfg, 3, "cpu")
        ref = one_device(cfg, params)
        pre = steps.build_prefill_step(cfg, PREFILL, mesh)
        dec = steps.build_decode_step(cfg, DECODE, mesh)
        p_loc = shard_state(params, pre.in_specs[0], mesh)
        log = shd.CollectiveLog()
        with shd.recording(log):
            logits, cache = pre.fn(
                p_loc, {"tokens": ref["toks"]},
                shard_state(_zeros(pre.args[2]), pre.in_specs[2], mesh))
        counts[(arch, "prefill")] = log.by_kind
        log = shd.CollectiveLog()
        with shd.recording(log):
            nxt, dlogits, dcache = dec.fn(
                p_loc, ref["tok"],
                shard_state(ref["decode_start"], dec.in_specs[2], mesh),
                ref["pos"])
        counts[(arch, "decode")] = log.by_kind
        same = {
            "prefill logits": torch.equal(logits, ref["logits"][rows]),
            "next tokens": torch.equal(nxt, ref["next"][rows]),
            "decode logits": torch.equal(dlogits, ref["dlogits"][rows])}
        for name, got, want, specs in (
                ("prefill cache", cache, ref["cache"], pre.in_specs[2]),
                ("decode cache", dcache, ref["dcache"], dec.in_specs[2])):
            leaves = []
            shd.map_specs(lambda g, w, s: leaves.append(
                g.shape == shd.local_slice(w, s, mesh).shape
                and torch.equal(g, shd.local_slice(w, s, mesh))),
                got, want, specs)
            same[name] = all(leaves) and len(leaves) == len(
                tree.leaves(want))
        equal[arch] = same
    cfg = reduced(get_config("qwen2-1.5b"))
    built = steps.build_train_step(cfg, TRAIN, mesh, num_microbatches=M)
    params = registry.init_params(cfg, 3, "cpu")
    state = shard_state({"p": params, "o": opt.init_opt_state(params)},
                        {"p": built.in_specs[0], "o": built.in_specs[1]},
                        mesh)
    log = shd.CollectiveLog()
    with shd.recording(log):
        built.fn(state["p"], state["o"],
                 {"tokens": _tokens(cfg, (B, S_PROMPT), 4)})
    counts[("qwen2-1.5b", "train")] = log.by_kind
    return {"coords": dict(mesh.coords), "equal": equal, "counts": counts}


def _traced_counts(mshape, coords):
    """What the dry run records for reduced qwen2-1.5b's three steps at
    this rank's coordinates of a traced mesh of ``mshape``."""
    from repro_torch.launch import dryrun
    cfg = reduced(get_config("qwen2-1.5b"))
    mesh = Mesh(tuple(zip(("data", "model"), mshape)))
    rank = coords["data"] * mshape[1] + coords["model"]
    out = {}
    for kind, shape, kw in (("prefill", PREFILL, {}), ("decode", DECODE, {}),
                            ("train", TRAIN, {"num_microbatches": M})):
        _, traced = dryrun.trace_cell(cfg, shape, mesh, rank=rank, **kw)
        out[kind] = {k: int(v) for k, v in traced.cost.coll_by_kind.items()}
    return out


def check_equal(ranks, mshape):
    for res in ranks:
        for arch, same in res["equal"].items():
            assert all(same.values()), (mshape, res["coords"], arch, same)


def check_counts(ranks, mshape):
    for res in ranks:
        want = _traced_counts(mshape, res["coords"])
        for kind in ("prefill", "decode", "train"):
            got = res["counts"][("qwen2-1.5b", kind)]
            assert got and got == want[kind], (mshape, res["coords"], kind,
                                               got, want[kind])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    with LocalWorld(2, tmp_path_factory.mktemp("mesh2_store")) as w:
        yield {(2, 1): w.run(serve_rank, 1), (1, 2): w.run(serve_rank, 2)}


@pytest.mark.parametrize("mshape", [(2, 1), (1, 2)])
def test_mesh_prefill_decode_equal_one_device_rows(worlds, mshape):
    assert [r["coords"] for r in worlds[mshape]] == [
        {"data": d, "model": m} for d in range(mshape[0])
        for m in range(mshape[1])]
    check_equal(worlds[mshape], mshape)


@pytest.mark.parametrize("mshape", [(2, 1), (1, 2)])
def test_traced_collectives_equal_what_the_steps_send(worlds, mshape):
    check_counts(worlds[mshape], mshape)
