"""The sharded train step in a gloo world of two ranks (reduced configs,
CPU).

One ``LocalWorld(2)`` for the module (``repro_torch.launch.local_world``:
a FileStore under ``tmp_path``, each collective timed out after 60 s,
each call joined with a deadline). Every rank builds
``build_train_step(cfg, shape, make_training_mesh(model=tp))``, holds
its shards of the seeded params and its ZeRO-1 shards of the optimizer
state, and steps on the global batches; the tests hold, after 3 steps
with 2 microbatches, at ``PERF.md`` section 2's train-step limits (loss,
grad norm, m and v at atol 1e-5 / rtol 1e-4; params and master at 0.1 x
the peak lr, whose Adam steps turn a gradient's last-bit rounding into a
visible step):

* at (data 2, model 1) and (data 1, model 2): every rank's loss and grad
  norm equal the unsharded port step's on the same batches, and its
  shards of params, m, v and master equal the slices of that step's
  results (``local_slice`` at the rank's coordinates), their shapes the
  shard shapes;
* the same with bf16 gradient compression, with the FSDP rules
  (``fsdp=True``: ``embed`` dims over ``data`` as well), and with bf16
  gradient accumulators at (2, 1);
* with HDP in training (``hdp.apply_in_training``) at (2, 1): the
  calibration scale is the split's maximum over the ranks, its gradient
  sent to the rank that holds it (``collectives.group_max``);
* the (2, 1) run's gathered state against JAX's jitted
  ``build_train_step`` on its one-device mesh (the reference's sharded
  code path) from the same weights and batches;
* ``launch.train --mesh cpu``: two steps with a checkpoint, the file
  equal bit for bit to the state the ranks gathered, every rank's shards
  the slices of it; a sharded run resumes an unsharded run's checkpoint
  and an unsharded run resumes a sharded run's, each step's loss the
  uninterrupted run's.

The world of four ranks at (2, 2) is ``test_torch_train_sharded_tp4.py``.
No test here sleeps on the wall clock; rank functions are module-level
and this file imports no jax at the top (the ranks import it).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.common import tree
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import Mesh
from repro_torch.launch.local_world import LocalWorld
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
#: params and master after Adam updates: 0.1 x the peak learning rate
PARAM_ATOL = 0.1 * opt.OptConfig().peak_lr
OCFG = dict(warmup_steps=1, decay_steps=10)
B, S, NM, STEPS, SEED = 4, 16, 2, 3, 3


def _batches(cfg, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))} for _ in range(n)]


def _cfg(arch="qwen2-1.5b", hdp=False):
    cfg = reduced(get_config(arch))
    if hdp:
        cfg = cfg.replace(hdp=cfg.hdp.replace(apply_in_training=True))
    return cfg


# ------------------------------------------------------ functions per rank
def train_rank(mshape, arch="qwen2-1.5b", comp="none", fsdp=None,
               accum=None, hdp=False):
    """One rank of a sharded run: STEPS steps of NM microbatches from
    SEED's weights; its coords, per-step metrics, local params and opt
    state, their specs, and the state gathered in full. ``accum`` makes
    the step with ``make_train_step(accum_dtype=accum)`` on the built
    step's shardings."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.training.train_loop import gather_state, shard_state
    cfg = _cfg(arch, hdp)
    mesh = make_training_mesh(model=mshape[-1])
    assert tuple(mesh.shape.values()) == tuple(mshape)
    shape = ShapeConfig("t", S, B, "train")
    built = steps.build_train_step(
        cfg, shape, mesh, rules=steps.choose_rules(cfg, "train", mesh,
                                                   fsdp=fsdp),
        num_microbatches=NM, grad_compression=comp,
        opt_cfg=opt.OptConfig(**OCFG))
    specs = {"params": built.in_specs[0], "opt": built.in_specs[1]}
    fn = built.fn if accum is None else make_train_step(
        cfg, opt.OptConfig(**OCFG), num_microbatches=NM,
        grad_compression=comp, param_shardings=specs["params"],
        opt_shardings=specs["opt"], mesh=mesh, accum_dtype=accum)
    params = registry.init_params(cfg, SEED, "cpu")
    st = shard_state({"params": params, "opt": opt.init_opt_state(params)},
                     specs, mesh)
    p, o = st["params"], st["opt"]
    mets = []
    for b in _batches(cfg):
        p, o, m = fn(p, o, b)
        mets.append({k: float(v) for k, v in m.items()})
    return {"coords": dict(mesh.coords), "metrics": mets, "params": p,
            "opt": o, "specs": specs,
            "full": gather_state({"params": p, "opt": o}, specs, mesh)}


def unsharded(arch="qwen2-1.5b", comp="none", accum=torch.float32,
              hdp=False):
    cfg = _cfg(arch, hdp)
    step = make_train_step(cfg, opt.OptConfig(**OCFG), num_microbatches=NM,
                           grad_compression=comp, accum_dtype=accum)
    params = registry.init_params(cfg, SEED, "cpu")
    o = opt.init_opt_state(params)
    mets = []
    for b in _batches(cfg):
        params, o, m = step(params, o, b)
        mets.append({k: float(v) for k, v in m.items()})
    return {"metrics": mets, "params": params, "opt": o}


def _close(a, b, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               b.detach().float().numpy(), atol=atol,
                               rtol=rtol, err_msg=what)


def check_ranks(ranks, want, mshape):
    """Every rank's metrics against the unsharded run's, and its shards
    against the slices of the unsharded results."""
    names = ("data", "model")
    for res in ranks:
        mesh = Mesh(tuple(zip(names, mshape)), coords=res["coords"])
        for i, (got, ref) in enumerate(zip(res["metrics"], want["metrics"])):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(got[k] - ref[k]) <= ATOL + RTOL * abs(ref[k]), \
                    (res["coords"], i, k, got[k], ref[k])
        for part, ref_tree, specs, atol in (
                ("params", want["params"], res["specs"]["params"],
                 PARAM_ATOL),
                ("m", want["opt"]["m"], res["specs"]["opt"]["m"], ATOL),
                ("v", want["opt"]["v"], res["specs"]["opt"]["v"], ATOL),
                ("master", want["opt"]["master"],
                 res["specs"]["opt"]["master"], PARAM_ATOL)):
            got_tree = res["params"] if part == "params" else \
                res["opt"][part]
            shd.map_specs(
                lambda g, r, s: (
                    tuple(g.shape) == shd.local_shape(r.shape, s, mesh)
                    or pytest.fail(f"{part}: shape {tuple(g.shape)}"),
                    _close(g, shd.local_slice(r, s, mesh),
                           f"{part} at {res['coords']}", atol)),
                got_tree, ref_tree, specs)
        assert int(res["opt"]["step"]) == STEPS


def _launch_rank(argvs):
    """``launch.train.run`` on this rank for each argv in turn (``--mesh
    cpu --device cpu`` added), recording the states it gathers and the
    one rank 0 writes. Returns per run (its result, the states gathered
    at each save with this rank's shards of them, what rank 0 wrote)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train_loop as tl
    gather, save = tl.gather_state, ckpt.save_checkpoint
    out = []
    for argv in argvs:
        seen, written = [], []

        def spy_gather(state, specs, mesh):
            full = gather(state, specs, mesh)
            seen.append((full, state, specs, dict(mesh.coords), mesh.axes))
            return full

        def spy_save(directory, step, state, **kw):
            written.append((step, tree.tree_map(
                lambda t: t.detach().clone(), state)))
            return save(directory, step, state, **kw)

        tl.gather_state, ckpt.save_checkpoint = spy_gather, spy_save
        try:
            res = train.run(train.build_parser().parse_args(
                [*argv, "--mesh", "cpu", "--device", "cpu"]))
        finally:
            tl.gather_state, ckpt.save_checkpoint = gather, save
        out.append({"result": res, "gathered": seen, "written": written,
                    "rank": dist.get_rank()})
    return out


# -------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = LocalWorld(2, tmp_path_factory.mktemp("train2_store"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def data2(world):
    """The (data 2, model 1) run, and the unsharded run it is held to."""
    return world.run(train_rank, (2, 1)), unsharded()


def test_data_parallel_equals_unsharded(data2):
    ranks, want = data2
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": 0},
                                            {"data": 1, "model": 0}]
    check_ranks(ranks, want, (2, 1))
    # ZeRO-1: each rank holds half of every optimizer leaf that an even
    # dim allows; the params stay whole under the TP rules at data 2
    for r in ranks:
        n_full = sum(t.numel() for t in tree.leaves(want["opt"]["master"]))
        n_loc = sum(t.numel() for t in tree.leaves(r["opt"]["master"]))
        assert n_loc * 2 == n_full
        assert sum(t.numel() for t in tree.leaves(r["params"])) == sum(
            t.numel() for t in tree.leaves(want["params"]))


def test_model_axis_equals_unsharded(world):
    ranks = world.run(train_rank, (1, 2))
    check_ranks(ranks, unsharded(), (1, 2))
    cfg = _cfg()
    for r in ranks:
        assert r["params"]["layers"]["attn"]["wq"].shape[2] == \
            cfg.n_heads // 2
        assert r["params"]["embed"]["tok"].shape[0] == cfg.vocab_size // 2


def test_bf16_compression_and_fsdp_equal_unsharded(world):
    """Compressed gradients at (2, 1), and the FSDP rules at (2, 1): the
    embed dims of the weights split over data as well, gathered on use."""
    comp = world.run(train_rank, (2, 1), comp="bf16")
    check_ranks(comp, unsharded(comp="bf16"), (2, 1))
    fsdp = world.run(train_rank, (2, 1), fsdp=True)
    check_ranks(fsdp, unsharded(), (2, 1))
    cfg = _cfg()
    assert tuple(fsdp[0]["specs"]["params"]["layers"]["ffn"]["w_up"]) == \
        (None, "data", "model")
    assert fsdp[0]["params"]["layers"]["ffn"]["w_up"].shape[1] == \
        cfg.d_model // 2


def test_bf16_accumulators_equal_unsharded(world):
    """bf16 gradient accumulators (the FSDP configs') at (2, 1): each
    split's gradient is reduced over data in fp32 and then rounded into
    the accumulator once, as the reference reduces every microbatch's
    gradient before it accumulates."""
    ranks = world.run(train_rank, (2, 1), accum=torch.bfloat16)
    check_ranks(ranks, unsharded(accum=torch.bfloat16), (2, 1))


def test_hdp_in_training_equals_unsharded(world):
    """``hdp.apply_in_training`` at (2, 1): HDP's calibration scale is the
    whole split's maximum (``collectives.group_max``, each rank holding
    one of its rows), and its cotangent reaches the rank that holds the
    maximum, so loss, grad norm and state equal the unsharded step's."""
    ranks = world.run(train_rank, (2, 1), hdp=True)
    want = unsharded(hdp=True)
    check_ranks(ranks, want, (2, 1))
    # HDP moved the loss: it is not the dense one
    dense = unsharded()
    assert want["metrics"][0]["loss"] != dense["metrics"][0]["loss"]


def test_gathered_state_equals_jax_build_train_step(data2):
    """JAX's ``build_train_step`` jitted on its one-device mesh, from the
    port's weights and batches: the (2, 1) run's gathered params, m, v
    and master and every step's loss and grad norm."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import reduced as jax_reduced
    from repro.launch import steps as jsteps
    from repro.models import registry as jreg
    from repro.training import optimizer as jopt
    ranks, _ = data2
    cfg = _cfg()
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    built = jsteps.build_train_step(jcfg, JShape("t", S, B, "train"), jmesh,
                                    num_microbatches=NM,
                                    opt_cfg=jopt.OptConfig(**OCFG))
    p = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                     registry.init_params(cfg, SEED, "cpu"))
    o = jopt.init_opt_state(p)
    # placed as the step's outputs are, so that one compile serves all
    p_abs, specs = built.args[0], jreg.param_specs(jcfg)
    p = jax.device_put(p, jsteps._shardings_for(p_abs, specs, jmesh,
                                                built.rules))
    o = jax.device_put(o, {"step": jsteps._replicated(jmesh), **{
        k: jsteps._shardings_for(built.args[1][k], specs, jmesh,
                                 built.rules, zero1=True)
        for k in ("m", "v", "master")}})
    for i, b in enumerate(_batches(cfg)):
        p, o, m = built.jitted(p, o, {"tokens": jnp.asarray(b["tokens"])})
        for k in ("loss", "grad_norm"):
            got = ranks[0]["metrics"][i][k]
            assert abs(got - float(m[k])) <= ATOL + RTOL * abs(float(m[k])), \
                (i, k, got, float(m[k]))
    full = {"params": ranks[0]["full"]["params"], **ranks[0]["full"]["opt"]}
    for a, b in zip(tree.leaves(ranks[0]["full"]),
                    tree.leaves(ranks[1]["full"])):
        assert torch.equal(a, b)
    for part, jt, atol in (("params", p, PARAM_ATOL), ("m", o["m"], ATOL),
                           ("v", o["v"], ATOL),
                           ("master", o["master"], PARAM_ATOL)):
        got, paths = tree.flatten_with_paths(full[part])
        jl = jax.tree_util.tree_flatten_with_path(jt)[0]
        assert paths == [jax.tree_util.keystr(k) for k, _ in jl]
        for t, (_, j), path in zip(got, jl, paths):
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                rtol=RTOL, err_msg=f"{part}{path}")


def _port_run(*argv):
    from repro_torch.launch import train
    return train.run(train.build_parser().parse_args(
        [*argv, "--device", "cpu"]))


def test_launcher_mesh_cpu_checkpoints_and_resumes(world, tmp_path):
    """Two sharded steps with a checkpoint: the file is the state the
    ranks gathered, bit for bit, and each rank's shards are its slices.
    A sharded run resumes the unsharded run's step-2 checkpoint, an
    unsharded run the sharded run's; each resumed step's loss is the
    uninterrupted run's."""
    from repro_torch.training import checkpoint as ckpt
    base = ["--arch", "qwen2-1.5b", "--reduced", "--log-every", "1"]
    full = _port_run(*base, "--steps", "3")
    plain_dir, sharded_dir = str(tmp_path / "plain"), str(tmp_path / "sh")
    _port_run(*base, "--steps", "2", "--checkpoint-dir", plain_dir)
    runs = world.run(_launch_rank, [
        base + ["--steps", "2", "--checkpoint-dir", sharded_dir,
                "--checkpoint-interval", "1"],
        base + ["--steps", "1", "--checkpoint-dir", plain_dir]])
    first, resumed = zip(*runs)
    for run in first:
        assert run["result"]["steps"] == 2
        assert run["result"]["mesh"] == {"data": 2, "model": 1}
        # saves at steps 1 and 2, and the final save (step 2 again)
        assert len(run["gathered"]) == 3
        for full_st, local, specs, coords, axes in run["gathered"]:
            mesh = Mesh(axes, coords=coords)
            shd.map_specs(lambda f, x, s: torch.equal(
                shd.local_slice(f, s, mesh), x) or pytest.fail(
                    f"shard at {coords} is not the slice of the gathered "
                    "state"), full_st, local, specs)
    assert [len(r["written"]) for r in first] == [3, 0]
    step, written = first[0]["written"][-1]
    assert step == 2
    for other in first[1:]:       # every rank gathered the same state
        for a, b in zip(tree.leaves(other["gathered"][-1][0]),
                        tree.leaves(first[0]["gathered"][-1][0])):
            assert torch.equal(a, b)
    loaded, s2, _ = ckpt.load_checkpoint(sharded_dir, written, device="cpu")
    assert s2 == 2
    for a, b, g in zip(tree.leaves(loaded), tree.leaves(written),
                       tree.leaves(first[0]["gathered"][-1][0])):
        assert a.dtype == b.dtype and torch.equal(a, b) and \
            torch.equal(a, g)
    want = [full["first_loss"], None, full["last_loss"]]
    for run in first:
        assert abs(run["result"]["first_loss"] - want[0]) <= \
            ATOL + RTOL * abs(want[0])
    for run in resumed:             # sharded, from the unsharded ckpt
        assert run["result"]["steps"] == 1
        assert abs(run["result"]["last_loss"] - want[2]) <= \
            ATOL + RTOL * abs(want[2])
    out = _port_run(*base, "--steps", "1", "--checkpoint-dir", sharded_dir)
    assert out["steps"] == 1 and abs(out["last_loss"] - want[2]) <= \
        ATOL + RTOL * abs(want[2])
