"""Train step: loss, microbatch gradient accumulation, optimizer update.

PyTorch counterpart of ``repro.training.train_loop``. The loss is
``logsumexp`` minus the gold logit (a gather: the reference's
iota-compare masked sum has one nonzero summand, so both give the same
value), plus the MoE aux loss. Gradients come from
``torch.autograd.grad`` on a detached copy of the parameter leaves, in
JAX's leaf order; microbatches accumulate in the reference's order.
Divisions by a constant count are products with its reciprocal, as XLA
compiles the reference's under ``jax.jit``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common import tree
from repro_torch.distribution.collectives import maybe_compress
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


def make_train_step(cfg, opt_cfg: opt.OptConfig, *, num_microbatches: int = 1,
                    grad_compression: str = "none",
                    accum_dtype=F32) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics) with metrics {"loss", "grad_norm", "lr"}.

    batch["tokens"]: [B_global, S]; with ``num_microbatches`` m > 1 the
    batch splits as ``x.reshape(m, B // m, ...)`` and the gradients
    accumulate over the splits in ``accum_dtype`` (activation memory is
    one split's). The step is pure: its inputs are left as they are."""
    param_dtype = L.torch_dtype(cfg.dtype)
    m = num_microbatches

    def train_step(params, opt_state, batch):
        if m > 1:
            inv = 1.0 / m
            micro = tree.tree_map(
                lambda x: x.reshape(m, x.shape[0] // m, *x.shape[1:]), batch)
            g_acc = tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=F32,
                               device=tree.leaves(params)[0].device)
            for i in range(m):
                mb = tree.tree_map(lambda x: x[i], micro)
                l_i, grads = _value_and_grad(cfg, params, mb,
                                             grad_compression)
                g_acc = tree.tree_map(
                    lambda a, g: (a.to(F32) + g.to(F32) * inv).to(accum_dtype),
                    g_acc, grads)
                del grads
                loss = loss + l_i * inv
            grads = g_acc
        else:
            loss, grads = _value_and_grad(cfg, params, batch,
                                          grad_compression)

        new_params, new_opt, om = opt.apply_updates(
            opt_cfg, grads, opt_state, param_dtype)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg) -> Callable:
    def prefill_step(params, batch, cache):
        logits, new_cache, _ = registry.apply_prefill(cfg, params, batch,
                                                      cache)
        return logits, new_cache
    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(params, token, cache, pos):
        logits, new_cache, _ = registry.apply_decode(cfg, params, token,
                                                     cache, pos)
        next_tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        return next_tok, logits, new_cache
    return decode_step
