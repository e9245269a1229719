"""AdamW with fp32 master weights, global-norm clipping and a
warmup+cosine schedule.

PyTorch counterpart of ``repro.training.optimizer``, line for line (not
``torch.optim.AdamW``: the decoupled decay sits inside the step,
``w - lr * (m_hat / (sqrt(v_hat) + eps) + wd * w)``, the bias
corrections are fp32 powers of the step, and the gradients are clipped
by their global norm first). Model params stay in the compute dtype
(bf16 at full width); the optimizer keeps fp32 master, m and v. Trees
are flattened in JAX's order (``common.tree``), so the norm sums its
leaves in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common import tree

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # accepted for field parity: in the reference it scans the update over
    # a layer stack to bound its temporaries, which changes memory only;
    # the port keeps the flat per-leaf update (the values are the same)
    scan_update_min_elems: int = 0


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """An fp32 0-d constant on ``like``'s device (a device fill)."""
    return torch.full((), x, dtype=F32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (int tensor): linear warmup, then a
    cosine decay to ``min_lr_ratio``. Divisions by a constant are
    products with its reciprocal, as XLA compiles the reference's."""
    step = step.to(F32)
    warm = cfg.peak_lr * step * (1.0 / max(cfg.warmup_steps, 1))
    t = torch.clamp((step - cfg.warmup_steps)
                    * (1.0 / max(cfg.decay_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_scalar(math.pi, step) * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """{"step": 0-d int32, "m", "v": fp32 zeros, "master": an fp32 copy
    of the params (a copy also when they are fp32 already)}."""
    device = tree.leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                 device=p.device), params),
        "v": tree.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                 device=p.device), params),
        "master": tree.tree_map(
            lambda p: p.detach().to(F32, copy=True), params),
    }


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (in fp32), summed leaf by
    leaf in JAX's flatten order."""
    sq = sum(torch.sum(torch.square(g.to(F32))) for g in tree.leaves(grads))
    return torch.sqrt(sq)


def apply_updates(cfg: OptConfig, grads, opt_state, param_dtype, *,
                  gnorm: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, metrics). Pure: the inputs are
    left as they are. The update is elementwise, so ``grads``, ``m``,
    ``v`` and ``master`` may be matching shards of the full trees (ZeRO-1)
    when ``gnorm``, the full gradient's global norm, is given; without it
    the norm is ``grads``'."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    # tensor / tensor: a python scalar on the left would become
    # reciprocal(x) * c, which rounds apart from the reference's division
    scale = torch.clamp(_scalar(cfg.clip_norm, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(_scalar(cfg.b1, stepf), stepf)
    b2c = 1.0 - torch.pow(_scalar(cfg.b2, stepf), stepf)

    def upd(g, m, v, w):
        g = g.to(F32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        w = w - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                      + cfg.weight_decay * w)
        return m, v, w

    new_m, new_v, new_w = [], [], []
    for g, m, v, w in zip(tree.leaves(grads), tree.leaves(opt_state["m"]),
                          tree.leaves(opt_state["v"]),
                          tree.leaves(opt_state["master"])):
        m2, v2, w2 = upd(g, m, v, w)
        new_m.append(m2)
        new_v.append(v2)
        new_w.append(w2)
    master = tree.unflatten(grads, new_w)
    new_params = tree.tree_map(lambda w: w.to(param_dtype), master)
    new_state = {"step": step,
                 "m": tree.unflatten(grads, new_m),
                 "v": tree.unflatten(grads, new_v),
                 "master": master}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
