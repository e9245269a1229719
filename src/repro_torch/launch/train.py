"""Training launcher.

    python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \
        --steps 50 --checkpoint-dir build/ckpt --device cpu

PyTorch counterpart of ``repro.launch.train``, with the same flags and
the same ``run(args) -> dict``. ``--device`` (default ``cuda``, as the
port's serve CLI) picks the device. Without ``--mesh`` the run is on one
device. ``--mesh cpu`` (the reference's mesh of the devices present)
trains sharded over the ranks of a ``torchrun`` launch (or of a process
group already up), on the mesh (data = ranks / ``--tp``, model =
``--tp``): each rank holds its shards of the params and its ZeRO-1
shards of the optimizer state, and trains on its rows of every batch
(``train_loop.make_train_step(mesh=)``)::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-1.5b --reduced --steps 3 --mesh cpu --device cpu

``--mesh single`` and ``multi`` name the production meshes, whose steps
are traced per shard by the dry run (``python -m
repro_torch.launch.dryrun``) and not run: they raise. Checkpoints keep
the unsharded format: a sharded run gathers the state and rank 0 writes
it, and every rank restores by slicing, so sharded and unsharded runs
resume each other.
Features exercised end-to-end: the train step (``steps.build_train_step``:
grad accumulation over ``micro_batches``, bf16 gradient compression,
AdamW with fp32 master weights), deterministic host-sharded data through
a background ``Prefetcher``, atomic checkpoints + resume, watchdog +
straggler log, retry-with-restore. Parameters come from the port's
seeded ``registry.init_params``; a run that starts from a checkpoint
(one the JAX launcher wrote included: the format is the same) restores
that state instead. Each step logs its loss, gradient norm and seconds.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced
from repro_torch.data.pipeline import (DataConfig, Prefetcher, host_slice,
                                       make_source)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import init_world, make_training_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import fault
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop as tl

log = logging.getLogger("repro_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=["cpu", "single", "multi"],
                    default=None,
                    help="train sharded over the ranks of the process "
                         "group (cpu); the production meshes (single, "
                         "multi) are the dry run's and raise")
    ap.add_argument("--tp", type=int, default=1,
                    help="the model axis of --mesh cpu (it must divide "
                         "the ranks)")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--grad-compression", choices=["none", "bf16"],
                    default="none")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-interval", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--data", choices=["synthetic", "memorize"],
                    default="synthetic")
    return ap


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _mesh_for(args):
    """None (one device), or the training mesh over the process group's
    ranks for ``--mesh cpu``."""
    if args.mesh is None:
        return None
    if args.mesh in ("single", "multi"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: a step on the production meshes is traced "
            "per shard, not run: python -m repro_torch.launch.dryrun; use "
            "--mesh cpu under torchrun")
    return make_training_mesh(model=args.tp)


def run(args) -> dict:
    cfg: ModelConfig = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape: ShapeConfig = SHAPES[args.shape]
    if args.seq_len or args.global_batch:
        shape = ShapeConfig(shape.name, args.seq_len or shape.seq_len,
                            args.global_batch or shape.global_batch, "train")
    if args.reduced and not (args.seq_len or args.global_batch):
        shape = ShapeConfig("train_smoke", 64, 8, "train")

    device = L.resolve_device(args.device)
    mesh = _mesh_for(args)
    log.info("device %s  mesh %s  arch %s  params %.2fM", device,
             None if mesh is None else mesh.shape, cfg.name,
             registry.param_count(cfg) / 1e6)

    built = steps_lib.build_train_step(
        cfg, shape, mesh, num_microbatches=args.microbatches,
        grad_compression=args.grad_compression)
    like = {"params": built.args[0], "opt": built.args[1]}
    specs = {"params": built.in_specs[0], "opt": built.in_specs[1]}
    writer = mesh is None or _rank() == 0

    def local(state):
        return state if mesh is None else tl.shard_state(state, specs, mesh)

    def init_state():
        params = registry.init_params(cfg, args.seed, device)
        return local({"params": params, "opt": opt.init_opt_state(params)})

    def restore():
        st, s0, _ = mgr.restore_or(like, init_state, device=device)
        return (local(st) if s0 else st), s0

    def save(step_no, params, opt_state, loss):
        state = {"params": params, "opt": opt_state}
        if mesh is not None:
            state = tl.gather_state(state, specs, mesh)
        mgr.save(step_no, state, meta={"loss": loss}, write=writer)
        if mesh is not None:
            # the files are committed before any rank goes on
            _barrier()

    step0 = 0
    if args.checkpoint_dir:
        mgr = ckpt.CheckpointManager(
            args.checkpoint_dir, interval=args.checkpoint_interval)
        state, step0 = restore()
        if step0:
            log.info("resumed from step %d", step0)
    else:
        mgr = None
        state = init_state()
    params, opt_state = state["params"], state["opt"]
    # each step returns new params and optimizer state; drop this handle
    # so the initial ones are freed once the first step replaces them
    # (the reference's jitted step donates its inputs' buffers)
    del state

    dcfg = DataConfig(cfg.vocab_size, shape.seq_len, shape.global_batch,
                      seed=args.seed, kind=args.data)
    source = make_source(dcfg)
    timer = fault.StepTimer()
    hung = {"flag": False}
    losses = []

    def on_timeout():
        hung["flag"] = True
        log.error("watchdog fired — requesting stop+checkpoint")

    t_start = time.time()
    with fault.Watchdog(args.watchdog_s, on_timeout) as wd, \
            Prefetcher(source, start_step=step0, sl=(
                host_slice(shape.global_batch) if mesh is None
                # every rank reads the global batch; the step takes its
                # rows (train_loop.local_rows)
                else slice(0, shape.global_batch))) as stream:
        for step in range(step0, step0 + args.steps):
            if hung["flag"]:
                break
            batch_np = next(stream)
            timer.start()

            def one_step(p, o, b):
                return built.fn(p, o, {"tokens": torch.as_tensor(
                    b, device=device)})

            def on_retry(attempt, exc):
                nonlocal params, opt_state
                if mgr is not None:
                    st, _ = restore()
                    params, opt_state = st["params"], st["opt"]

            params, opt_state, metrics = fault.retry(
                one_step, params, opt_state, batch_np["tokens"],
                on_retry=on_retry)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = timer.stop(step)
            wd.beat()
            if step % args.log_every == 0:
                log.info("step %5d  loss %.4f  grad_norm %.4f  %.3fs", step,
                         loss, float(metrics["grad_norm"]), dt)
            if mgr is not None and mgr.should_save(step + 1):
                save(step + 1, params, opt_state, loss)
        if mgr is not None:
            save(step0 + len(losses), params, opt_state,
                 losses[-1] if losses else None)

    out = {
        "steps": len(losses),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": time.time() - t_start,
        "mesh": None if mesh is None else mesh.shape,
        **{f"timer_{k}": v for k, v in timer.summary().items()},
    }
    log.info("done: %s", out)
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    joined = False
    if args.mesh is not None:
        import torch.distributed as dist
        joined = not dist.is_initialized()
        _, args.device = init_world(args.device)
        joined = joined and dist.is_initialized()
    try:
        out = run(args)
    finally:
        if joined:
            dist.destroy_process_group()
    ok = out["steps"] > 0 and np.isfinite(out["last_loss"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
