"""Step builders: abstract state + the step function per (arch, shape).

PyTorch counterpart of ``repro.launch.steps`` on one device. The
reference's builders also choose sharding rules and jit each step over a
mesh; the port's meshes serve only so far (``launch/mesh.py``; the
train step's shardings are ROADMAP.md section 1, item 8b), so a
built step is the eager function, its abstract arguments (meta tensors
and ``registry.ShapeDtype``s) and its metadata. ``FSDP_THRESHOLD`` still
picks the gradient accumulators' dtype (bf16 from 8e9 parameters), as
in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (
    make_decode_step, make_prefill_step, make_train_step)

FSDP_THRESHOLD = 8e9


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    args: Tuple           # abstract args (meta tensors, ShapeDtypes)
    meta: Dict


def micro_batches(cfg: ModelConfig, shape: ShapeConfig,
                  micro_tokens: int = 4096) -> int:
    """Grad-accumulation factor: per-device microbatch ~micro_tokens (one
    device: data-parallel width 1)."""
    dp = 1
    b_local = shape.global_batch // dp
    want = max(1, (b_local * shape.seq_len)
               // max(micro_tokens, shape.seq_len))
    m = min(want, b_local)
    while m > 1 and (shape.global_batch % m
                     or (shape.global_batch // m) % dp):
        m -= 1
    return m


def _abstract_params(cfg):
    return registry.init_params(cfg, device="meta")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, *,
                     num_microbatches: Optional[int] = None,
                     grad_compression: str = "none",
                     opt_cfg: Optional[opt.OptConfig] = None) -> BuiltStep:
    nm = num_microbatches or micro_batches(cfg, shape)
    big = registry.param_count(cfg) >= FSDP_THRESHOLD
    params_abs = _abstract_params(cfg)
    opt_abs = opt.init_opt_state(params_abs)
    batch_abs = registry.input_specs(cfg, shape)["batch"]
    fn = make_train_step(cfg, opt_cfg or opt.OptConfig(),
                         num_microbatches=nm,
                         grad_compression=grad_compression,
                         accum_dtype=torch.bfloat16 if big else torch.float32)
    return BuiltStep(fn, (params_abs, opt_abs, batch_abs),
                     {"num_microbatches": nm, "kind": "train"})


def _cache_abs(cfg, shape: ShapeConfig, kind: str):
    B = shape.global_batch
    max_len = registry.decode_cache_len(cfg, shape)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_len"] = (shape.seq_len if kind == "prefill"
                         else (cfg.max_source_positions or 1500))
    if kind == "prefill":
        max_len = shape.seq_len
    return registry.init_cache(cfg, B, max_len=max_len, device="meta", **kw)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> BuiltStep:
    batch_abs = registry.input_specs(cfg, shape)["batch"]
    return BuiltStep(make_prefill_step(cfg),
                     (_abstract_params(cfg), batch_abs,
                      _cache_abs(cfg, shape, "prefill")),
                     {"kind": "prefill"})


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig) -> BuiltStep:
    ins = registry.input_specs(cfg, shape)
    return BuiltStep(make_decode_step(cfg),
                     (_abstract_params(cfg), ins["token"],
                      _cache_abs(cfg, shape, "decode"), ins["pos"]),
                     {"kind": "decode"})


def build_step(cfg: ModelConfig, shape: ShapeConfig, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, **kw)
    return build_decode_step(cfg, shape, **kw)
