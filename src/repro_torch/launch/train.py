"""Training launcher.

    python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \
        --steps 50 --checkpoint-dir build/ckpt --device cpu

PyTorch counterpart of ``repro.launch.train``, with the same flags and
the same ``run(args) -> dict``, except that ``--device`` (default
``cuda``, as the port's serve CLI) takes the place of ``--mesh``: the
port trains on one device (its sharding is ROADMAP.md section 1,
item 8b).
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
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import fault
from repro_torch.training import optimizer as opt

log = logging.getLogger("repro_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cuda")
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
    log.info("device %s  arch %s  params %.2fM", device, cfg.name,
             registry.param_count(cfg) / 1e6)

    built = steps_lib.build_train_step(
        cfg, shape, num_microbatches=args.microbatches,
        grad_compression=args.grad_compression)
    like = {"params": built.args[0], "opt": built.args[1]}

    def init_state():
        params = registry.init_params(cfg, args.seed, device)
        return {"params": params, "opt": opt.init_opt_state(params)}

    step0 = 0
    if args.checkpoint_dir:
        mgr = ckpt.CheckpointManager(
            args.checkpoint_dir, interval=args.checkpoint_interval)
        state, step0, _ = mgr.restore_or(like, init_state, device=device)
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
            Prefetcher(source, start_step=step0,
                       sl=host_slice(shape.global_batch)) as stream:
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
                    st, _, _ = mgr.restore_or(like, init_state,
                                              device=device)
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
            if mgr is not None:
                mgr.maybe_save(step + 1,
                               {"params": params, "opt": opt_state},
                               meta={"loss": loss})
        if mgr is not None:
            mgr.save(step0 + len(losses),
                     {"params": params, "opt": opt_state},
                     meta={"loss": losses[-1] if losses else None})

    out = {
        "steps": len(losses),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": time.time() - t_start,
        **{f"timer_{k}": v for k, v in timer.summary().items()},
    }
    log.info("done: %s", out)
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    out = run(args)
    ok = out["steps"] > 0 and np.isfinite(out["last_loss"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
