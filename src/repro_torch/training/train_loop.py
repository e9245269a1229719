"""Train step: loss, microbatch gradient accumulation, optimizer update.

PyTorch counterpart of ``repro.training.train_loop``. The loss is
``logsumexp`` minus the gold logit (a gather: the reference's
iota-compare masked sum has one nonzero summand, so both give the same
value), plus the MoE aux loss. Gradients come from
``torch.autograd.grad`` on a detached copy of the parameter leaves, in
JAX's leaf order; microbatches accumulate in the reference's order.
Divisions by a constant count are products with its reciprocal, as XLA
compiles the reference's under ``jax.jit``. With a mesh, the step is one
rank's of the sharded step (``make_train_step(mesh=)``): params held as
shards, gathered on use; the optimizer state in ZeRO-1 shards; the
gradients all-reduced over the data-parallel axes. The prefill and decode
steps on a mesh gather on use too (``_sharded_serving``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common import tree
from repro_torch.common.loops import trips
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.collectives import (data_parallel,
                                                  maybe_compress, round_bf16)
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.training import optimizer as opt

F32 = torch.float32


def lm_loss(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy averaged over B*(S-1) positions, plus the
    aux loss: (loss, {"nll", "aux_loss"})."""
    logits, extras = registry.apply_train(cfg, params, batch)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(F32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    per_tok = lse - gold
    nll = per_tok.sum() * (1.0 / per_tok.numel())
    loss = nll + extras["aux_loss"]
    return loss, {"nll": nll, "aux_loss": extras["aux_loss"]}


def _value_and_grad(cfg, params, batch, grad_compression: str):
    """(loss, grads) of ``lm_loss`` at ``params``; a parameter the loss
    does not reach gets a zero gradient, as JAX gives it."""
    leaves = tree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, _ = lm_loss(cfg, maybe_compress(tree.unflatten(params, live),
                                              grad_compression), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree.unflatten(params, grads)


def _accumulate(cfg, params, batch, m: int, grad_compression: str,
                accum_dtype, reduce=None):
    """(mean loss, gradients) over ``batch`` split as
    ``x.reshape(m, B // m, ...)``, the gradients accumulated over the
    splits in ``accum_dtype`` in the reference's order (activation memory
    is one split's). ``reduce(loss, grads)``, where given, turns each
    split's values into the data-parallel group's, in fp32, before the
    bf16 compression or the accumulator rounds them (``_sharded_step``)."""
    def one(mb):
        if reduce is None:
            return _value_and_grad(cfg, params, mb, grad_compression)
        loss, grads = reduce(*_value_and_grad(cfg, params, mb, "none"))
        if grad_compression != "none":
            grads = tree.tree_map(round_bf16, grads)
        return loss, grads

    if m == 1:
        return one(batch)
    inv = 1.0 / m
    micro = tree.tree_map(
        lambda x: x.reshape(m, x.shape[0] // m, *x.shape[1:]), batch)
    g_acc = tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device),
        params)
    loss = torch.zeros((), dtype=F32, device=tree.leaves(params)[0].device)
    for i in trips(m):      # identical splits: a trace counts one m times
        l_i, grads = one(tree.tree_map(lambda x: x[i], micro))
        g_acc = tree.tree_map(
            lambda a, g: (a.to(F32) + g.to(F32) * inv).to(accum_dtype),
            g_acc, grads)
        del grads
        loss = loss + l_i * inv
    return loss, g_acc


def make_train_step(cfg, opt_cfg: opt.OptConfig, *, num_microbatches: int = 1,
                    grad_compression: str = "none",
                    param_shardings=None, opt_shardings=None, mesh=None,
                    accum_dtype=F32) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics) with metrics {"loss", "grad_norm", "lr"}.

    batch["tokens"]: [B_global, S]; with ``num_microbatches`` m > 1 the
    batch splits as ``x.reshape(m, B // m, ...)`` and the gradients
    accumulate over the splits in ``accum_dtype`` (activation memory is
    one split's). The step is pure: its inputs are left as they are.

    Without a ``mesh`` the step runs on one device and the shardings are
    not read. With a mesh bound to ranks it is the sharded step of one
    rank (``_sharded_step``): ``params`` and ``opt_state`` hold this
    rank's shards by ``param_shardings`` and ``opt_shardings`` (the
    PartitionSpec trees of ``launch.steps.build_train_step``), the batch
    is the global one, and every rank of the mesh calls the step at
    once."""
    param_dtype = L.torch_dtype(cfg.dtype)
    m = num_microbatches
    if mesh is not None:
        if param_shardings is None or opt_shardings is None:
            raise ValueError("a sharded train step needs param_shardings "
                             "and opt_shardings")
        return _sharded_step(cfg, opt_cfg, m, grad_compression, accum_dtype,
                             param_shardings, opt_shardings, mesh)

    def train_step(params, opt_state, batch):
        loss, grads = _accumulate(cfg, params, batch, m, grad_compression,
                                  accum_dtype)
        new_params, new_opt, om = opt.apply_updates(
            opt_cfg, grads, opt_state, param_dtype)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, major to minor (the reference's
    ``batch`` rule, ``("pod", "data")``, on the axes the mesh has)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def local_rows(mesh, global_batch: int, m: int):
    """This rank's rows of the global batch, microbatch by microbatch, as
    the reference assigns them: the batch splits into ``m`` microbatches
    ``x.reshape(m, B // m, ...)`` and each microbatch over the
    data-parallel axes, major to minor. None where the data-parallel
    width does not divide the batch (the reference replicates it then:
    every rank trains on every row)."""
    axes = data_axes(mesh)
    r, dp = shd.shard_index(mesh, axes)
    if global_batch % dp:
        return None
    per_micro = global_batch // m
    if per_micro % dp:
        raise ValueError(f"{m} microbatches of a batch of {global_batch} "
                         f"do not split over a data-parallel width of {dp}")
    per = per_micro // dp
    return [i * per_micro + r * per + j for i in range(m) for j in range(per)]


def _sharded_step(cfg, opt_cfg, m, grad_compression, accum_dtype, p_specs,
                  o_specs, mesh) -> Callable:
    """One rank's train step on ``mesh``.

    The rank gathers every params leaf in full over the axes its spec
    names, runs forward and backward on its rows (``local_rows``) with
    ``m`` microbatches accumulated as the unsharded step does, sums the
    gradients and the loss over the data-parallel group and scales them
    by 1/dp (split by split under bf16 compression or a bf16
    accumulator). Every rank then holds the full reduced gradient: it takes
    the global norm there (so every rank clips alike), updates its ZeRO-1
    shards of ``m``, ``v`` and ``master``, and rebuilds its params shard
    by gathering the new master over the axes ``zero1_spec`` added, cast
    to the model dtype. On ``model`` the ranks hold disjoint shards and
    compute the same rows: that axis splits the memory of the weights and
    the optimizer state, not the compute."""
    param_dtype = L.torch_dtype(cfg.dtype)
    z_specs = o_specs["master"]         # m and v are laid out alike

    def train_step(params, opt_state, batch):
        shd.require_ranks(mesh)
        axes = data_axes(mesh)
        dp = shd.shard_index(mesh, axes)[1]
        rows = local_rows(mesh, tree.leaves(batch)[0].shape[0], m)
        if rows is not None:
            idx = torch.tensor(rows, device=tree.leaves(batch)[0].device)
            batch = tree.tree_map(lambda x: x.index_select(0, idx), batch)
        full = shd.map_specs(lambda p, s: shd.gather_full(p, s, mesh),
                             params, p_specs)
        inv = 1.0 / dp

        def mean(x):
            """x averaged over the data-parallel group, in fp32."""
            x = x.to(F32, copy=True)
            shd.all_reduce_axes(x, mesh, axes)
            return x * inv

        def reduce(loss, grads):
            return mean(loss.reshape(1))[0], tree.tree_map(mean, grads)

        sharded = rows is not None and dp > 1
        # the bf16 compression and a bf16 accumulator round each leaf's
        # whole gradient, summed over every row of a split, as in the
        # reference: then each split is reduced before the rounding (m
        # all-reduces, not one)
        per_split = sharded and (grad_compression != "none"
                                 or accum_dtype != F32)
        with data_parallel(mesh, axes if sharded else ()):
            loss, grads = _accumulate(cfg, full, batch, m, grad_compression,
                                      accum_dtype,
                                      reduce=reduce if per_split else None)
        del full
        if sharded and not per_split:
            # the sum over ranks accumulates like the splits' sum
            loss, grads = reduce(loss, grads)
        gnorm = opt.global_norm(grads)
        local = shd.map_specs(lambda g, z: shd.local_slice(g, z, mesh),
                              grads, z_specs)
        del grads
        new_z, new_opt, om = opt.apply_updates(
            opt_cfg, local, opt_state, param_dtype, gnorm=gnorm)
        new_params = shd.map_specs(
            lambda p, z, s: shd.reshard(p, z, s, mesh), new_z, z_specs,
            p_specs)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def shard_state(state, specs, mesh):
    """This rank's shards of a full state tree (params, or {"params",
    "opt"}) by the matching PartitionSpec tree (``BuiltStep.in_specs``),
    each a copy of its own, so the full tensors can be freed."""
    return shd.map_specs(lambda x, s: shd.local_slice(x, s, mesh).clone(),
                         state, specs)


def gather_state(state, specs, mesh):
    """The full state tree from this rank's shards: the same on every
    rank, every rank of the mesh calling it at once."""
    return shd.map_specs(lambda x, s: shd.gather_full(x, s, mesh), state,
                         specs)


def _only(spec, axes):
    """``spec`` with each dim keeping only the mesh axes in ``axes``."""
    parts = []
    for part in spec:
        names = tuple(a for a in ((part,) if isinstance(part, str)
                                  else part or ()) if a in axes)
        parts.append(names[0] if len(names) == 1 else (names or None))
    return shd.PartitionSpec(*parts)


def _own(x, spec, mesh):
    """This rank's shard of ``x`` under ``spec``, a tensor of its own
    where anything was cut (so the gathered tensor can be freed)."""
    part = shd.local_slice(x, spec, mesh)
    return part.clone() if part.shape != x.shape else part


def _sharded_serving(step, p_specs, c_specs, mesh) -> Callable:
    """One rank's prefill or decode step on ``mesh`` (bound to ranks, or
    traced), gathering on use as ``_sharded_step`` does: the rank takes
    its rows of the global batch (or tokens) over ``("pod", "data")``,
    gathers every params leaf in full and its cache shard over the axes
    its spec names beyond the batch (``kv_heads`` or ``kv_seq`` on
    ``model``, by ``launch.steps.choose_rules``), runs ``step`` on them,
    and returns the outputs of its rows with its own shard of the new
    cache. A statistic over the batch is the data-parallel group's
    (``collectives.group_max`` in HDP's calibration), so each row equals
    the one-device step's. On ``model`` the ranks hold disjoint shards
    and compute the same rows: that axis splits memory, not compute."""
    axes = data_axes(mesh)
    rest = tuple(a for a in mesh.axis_names if a not in axes)

    def sharded(params, inputs, cache, *args):
        shd.require_ranks(mesh)
        first = tree.leaves(inputs)[0]
        rows = local_rows(mesh, first.shape[0], 1)
        if rows is not None:
            idx = torch.tensor(rows, device=first.device)
            inputs = tree.tree_map(lambda x: x.index_select(0, idx), inputs)
        full = shd.map_specs(lambda p, s: shd.gather_full(p, s, mesh),
                             params, p_specs)
        cache = shd.map_specs(
            lambda c, s: shd.reshard(c, s, _only(s, axes), mesh), cache,
            c_specs)
        # a statistic over the batch (HDP's calibration scale) is the
        # whole batch's, as on one device
        split = rows is not None and shd.shard_index(mesh, axes)[1] > 1
        with data_parallel(mesh, axes if split else ()):
            *outs, new_cache = step(full, inputs, cache, *args)
        del full, cache
        return (*outs, shd.map_specs(lambda c, s: _own(c, _only(s, rest),
                                                       mesh),
                                     new_cache, c_specs))

    return sharded


def make_prefill_step(cfg, *, param_shardings=None, cache_shardings=None,
                      mesh=None) -> Callable:
    """prefill_step(params, batch, cache) -> (logits, cache). With a mesh
    bound to ranks (or traced) it is one rank's step: ``params`` and
    ``cache`` hold this rank's shards by ``param_shardings`` and
    ``cache_shardings`` (``launch.steps.build_prefill_step``'s specs),
    the batch is the global one, and the logits and cache are this
    rank's rows and shard (``_sharded_serving``)."""
    def prefill_step(params, batch, cache):
        logits, new_cache, _ = registry.apply_prefill(cfg, params, batch,
                                                      cache)
        return logits, new_cache
    if mesh is None:
        return prefill_step
    return _sharded_serving(prefill_step, param_shardings, cache_shardings,
                            mesh)


def make_decode_step(cfg, *, param_shardings=None, cache_shardings=None,
                     mesh=None) -> Callable:
    """decode_step(params, token, cache, pos) -> (next tokens, logits,
    cache); ``pos`` a scalar (every row at one position, the reference's
    aligned batch) or per-row positions. With a mesh, one rank's step as
    ``make_prefill_step``'s: ``token`` is the global one, ``pos`` a
    scalar, the outputs its rows and its cache shard."""
    def decode_step(params, token, cache, pos):
        if pos.dim() == 0:
            # the reference's aligned batch: every row at one position
            # (the port's dense caches take per-row positions)
            B, S = token.shape
            pos = (pos + torch.arange(S, dtype=pos.dtype,
                                      device=pos.device)).expand(B, S)
        logits, new_cache, _ = registry.apply_decode(cfg, params, token,
                                                     cache, pos)
        next_tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        return next_tok, logits, new_cache
    if mesh is None:
        return decode_step
    step = _sharded_serving(decode_step, param_shardings, cache_shardings,
                            mesh)

    def mesh_decode_step(params, token, cache, pos):
        if pos.dim():
            raise ValueError("a decode step on a mesh takes one position "
                             f"for every row (a scalar), got {pos.shape}")
        return step(params, token, cache, pos)
    return mesh_decode_step
