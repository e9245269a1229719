"""Step builders: abstract state + shardings + the step function per
(arch, shape, mesh).

PyTorch counterpart of ``repro.launch.steps``, shared by the launchers
and the tests. ``choose_rules`` picks the logical->physical rules of a
cell as the reference does; the builders resolve them, with the params'
logical specs (``registry.param_specs``), into ``PartitionSpec`` trees:
params by ``spec_for``, the optimizer's ``m``, ``v`` and ``master`` by
``zero1_spec`` (ZeRO-1), ``step`` replicated, every input sharded on
``batch``, the caches by ``registry.cache_specs``. ``BuiltStep.in_specs``
holds them in the order of the step's arguments, as the reference's
``in_shardings``.

A mesh bound to ranks (``launch.mesh.make_training_mesh``), or traced
(``launch.mesh.traced_mesh``), gives one rank's sharded step
(``train_loop.make_train_step(mesh=)``, ``make_prefill_step(mesh=)``,
``make_decode_step(mesh=)``): params gathered on use, the rank's rows of
the batch, the prefill and decode caches gathered over ``model`` and
returned as the rank's shard. The ``model`` axis splits memory, not
compute. ``mesh=None`` is one device, on which every spec resolves over
a (1, 1) mesh and the step is the unsharded one. A step built on the
abstract production mesh (``make_production_mesh``) has its specs but
raises when called: its cells are traced per shard by the dry run
(``python -m repro_torch.launch.dryrun``). Sharded serving is the
engine's (``Engine(tp=)``); the mesh prefill and decode steps are what
the dry run traces. ``FSDP_THRESHOLD`` picks the FSDP rules and the
gradient accumulators' dtype (bf16 from 8e9 parameters), as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import Mesh, PartitionSpec as P
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (
    make_decode_step, make_prefill_step, make_train_step)

FSDP_THRESHOLD = 8e9

#: the mesh that ``mesh=None`` (one device) resolves specs on
ONE_DEVICE = Mesh((("data", 1), ("model", 1)))


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    args: Tuple           # abstract args (meta tensors, ShapeDtypes)
    rules: Dict
    meta: Dict
    #: PartitionSpec trees of ``args`` (the reference's in_shardings;
    #: None for an argument it leaves unconstrained)
    in_specs: Tuple = ()


def choose_rules(cfg: ModelConfig, kind: str, mesh: Optional[Mesh],
                 *, fsdp: Optional[bool] = None,
                 seq_shard_prefill: bool = True) -> Dict:
    """Pick logical->physical rules for this (arch, shape kind, mesh)."""
    mesh = mesh or ONE_DEVICE
    big = registry.param_count(cfg) >= FSDP_THRESHOLD if fsdp is None else fsdp
    rules = dict(shd.RULES_FSDP_TP if big else shd.RULES_TP)
    msz = mesh.shape.get("model", 1)
    if kind == "prefill" and seq_shard_prefill:
        # context parallelism: activations + cache sharded over sequence
        rules["seq_act"] = "model"
    if cfg.n_heads and cfg.n_heads % msz:
        # heads can't shard over `model`: attention activations fall
        # back to sequence sharding (the reference's note)
        rules["seq_act"] = "model"
    if big and cfg.n_experts:
        # a large MoE shards its experts over `data` (EP) and the expert
        # mlp dim over `model`, with no gather at use (the reference's
        # note: FSDP gathers of the whole expert stack run out of memory)
        dsz = mesh.shape.get("data", 1)
        if cfg.n_experts % dsz == 0:
            rules["experts"] = "data"
            rules["experts_act"] = "data"
    if kind in ("prefill", "decode"):
        if cfg.n_kv_heads and cfg.n_kv_heads % msz == 0:
            rules["kv_heads"], rules["kv_seq"] = "model", None
        else:
            rules["kv_heads"], rules["kv_seq"] = None, "model"
    return rules


def _shardings_for(tree, logical, mesh, rules, zero1=False):
    """The PartitionSpec of every leaf of ``tree`` from its logical axes
    in ``logical`` (``zero1``: the optimizer state's, ``zero1_spec``)."""
    def one(x, ax):
        ax = tuple(ax)
        return (shd.zero1_spec(ax, x.shape, mesh, rules) if zero1
                else shd.spec_for(ax, x.shape, mesh, rules))
    return shd.map_specs(one, tree, logical)


def _batch_shardings(batch_abs, mesh, rules):
    def one(x):
        ax = ("batch",) + (None,) * (len(x.shape) - 1)
        return shd.spec_for(ax, x.shape, mesh, rules)
    return {k: one(x) for k, x in batch_abs.items()}


def micro_batches(cfg: ModelConfig, shape: ShapeConfig,
                  mesh: Optional[Mesh] = None,
                  micro_tokens: int = 4096) -> int:
    """Grad-accumulation factor: per-device microbatch ~micro_tokens."""
    mesh = mesh or ONE_DEVICE
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    if shape.global_batch % dp:
        dp = 1  # batch replicated (e.g. long_500k B=1)
    b_local = shape.global_batch // dp
    want = max(1, (b_local * shape.seq_len)
               // max(micro_tokens, shape.seq_len))
    m = min(want, b_local)
    while m > 1 and (shape.global_batch % m
                     or (shape.global_batch // m) % dp):
        m -= 1
    return m


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     mesh: Optional[Mesh] = None, *,
                     rules: Optional[Dict] = None,
                     num_microbatches: Optional[int] = None,
                     grad_compression: str = "none",
                     opt_cfg: Optional[opt.OptConfig] = None) -> BuiltStep:
    rules = rules or choose_rules(cfg, "train", mesh)
    nm = num_microbatches or micro_batches(cfg, shape, mesh)
    big = registry.param_count(cfg) >= FSDP_THRESHOLD
    params_abs, specs = registry.abstract_params(cfg)
    opt_abs = opt.init_opt_state(params_abs)
    batch_abs = registry.input_specs(cfg, shape)["batch"]

    on = mesh or ONE_DEVICE
    p_sh = _shardings_for(params_abs, specs, on, rules)
    o_sh = {"step": P(),
            **{k: _shardings_for(opt_abs[k], specs, on, rules, zero1=True)
               for k in ("m", "v", "master")}}
    b_sh = _batch_shardings(batch_abs, on, rules)

    fn = make_train_step(cfg, opt_cfg or opt.OptConfig(),
                         num_microbatches=nm,
                         grad_compression=grad_compression,
                         param_shardings=p_sh, opt_shardings=o_sh,
                         mesh=mesh,
                         accum_dtype=torch.bfloat16 if big else torch.float32)
    return BuiltStep(fn, (params_abs, opt_abs, batch_abs), rules,
                     {"num_microbatches": nm, "kind": "train"},
                     (p_sh, o_sh, b_sh))


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


def _on_mesh(make: Callable, mesh: Optional[Mesh], p_sh, c_sh) -> Callable:
    """``make()``'s one-device step where the mesh is one device, one
    rank's step on a mesh bound to ranks or traced; on an abstract mesh
    a function that raises (``require_ranks``: the dry run traces it)."""
    if mesh is None or (mesh.coords is not None and mesh.size == 1
                        and not mesh.traced):
        return make()
    if mesh.coords is None:
        def refused(*args, **kw):
            shd.require_ranks(mesh)
        return refused
    return make(param_shardings=p_sh, cache_shardings=c_sh, mesh=mesh)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh: Optional[Mesh] = None, *,
                       rules: Optional[Dict] = None) -> BuiltStep:
    rules = rules or choose_rules(cfg, "prefill", mesh)
    params_abs, specs = registry.abstract_params(cfg)
    batch_abs = registry.input_specs(cfg, shape)["batch"]
    cache_abs = _cache_abs(cfg, shape, "prefill")
    on = mesh or ONE_DEVICE
    in_specs = (_shardings_for(params_abs, specs, on, rules),
                _batch_shardings(batch_abs, on, rules),
                _shardings_for(cache_abs, registry.cache_specs(cfg), on,
                               rules))
    fn = _on_mesh(lambda **kw: make_prefill_step(cfg, **kw), mesh,
                  in_specs[0], in_specs[2])
    return BuiltStep(fn, (params_abs, batch_abs, cache_abs), rules,
                     {"kind": "prefill"}, in_specs)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      mesh: Optional[Mesh] = None, *,
                      rules: Optional[Dict] = None) -> BuiltStep:
    rules = rules or choose_rules(cfg, "decode", mesh)
    params_abs, specs = registry.abstract_params(cfg)
    ins = registry.input_specs(cfg, shape)
    cache_abs = _cache_abs(cfg, shape, "decode")
    on = mesh or ONE_DEVICE
    in_specs = (_shardings_for(params_abs, specs, on, rules),
                _batch_shardings({"token": ins["token"]}, on,
                                 rules)["token"],
                _shardings_for(cache_abs, registry.cache_specs(cfg), on,
                               rules),
                None)
    fn = _on_mesh(lambda **kw: make_decode_step(cfg, **kw), mesh,
                  in_specs[0], in_specs[2])
    return BuiltStep(fn, (params_abs, ins["token"], cache_abs, ins["pos"]),
                     rules, {"kind": "decode"}, in_specs)


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               mesh: Optional[Mesh] = None, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **kw)
    return build_decode_step(cfg, shape, mesh, **kw)
