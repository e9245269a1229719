"""Distributed-optimization helpers.

Gradient compression: an identity whose backward rounds an fp32
cotangent through bf16. Placed at parameter use-sites, it makes autograd
*produce* bf16-valued gradients, so a data-parallel all-reduce would move
half the bytes. The optimizer upcasts back to fp32 before the update
(the error is bounded by bf16 rounding of the *summed* gradient).
PyTorch counterpart of ``repro.distribution.collectives``.

``group_mean`` averages a batch statistic over the ranks of the ambient
data-parallel group (``data_parallel``), differentiably: the sharded
train step runs each rank's rows of a microbatch, and a statistic over
the microbatch's rows (the MoE load-balancing loss's expert shares) must
be the whole microbatch's, as in the reference, where the batch is one
array. ``group_max`` takes the group's maximum the same way (HDP's
per-tensor calibration scale, in the mesh train, prefill and decode
steps), its cotangent sent to the rank that holds the maximum.
Both go through ``sharding.all_reduce_axes``, so they record what they
send and only record on a traced mesh.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.common import tree

_ctx = threading.local()


class _CompressGradsBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def round_bf16(g: torch.Tensor) -> torch.Tensor:
    """An fp32 gradient rounded through bf16 (other dtypes as they are):
    what the compression's backward does to a leaf's gradient."""
    if g.dtype == torch.float32:
        return g.to(torch.bfloat16).to(g.dtype)
    return g


def compress_grads_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward rounds an fp32 cotangent through
    bf16 and leaves other dtypes alone."""
    return _CompressGradsBF16.apply(x)


def maybe_compress(params, mode: str):
    """Apply gradient compression to every leaf ('bf16') or pass through
    ('none': the same tree object)."""
    if mode == "none":
        return params
    if mode == "bf16":
        return tree.tree_map(compress_grads_bf16, params)
    raise ValueError(f"unknown gradient compression mode {mode!r}")


@contextmanager
def data_parallel(mesh, axes):
    """Make (``mesh``, its data-parallel ``axes``) the ambient group of
    ``group_mean`` for the calling thread."""
    prev = getattr(_ctx, "group", None)
    _ctx.group = (mesh, tuple(axes))
    try:
        yield
    finally:
        _ctx.group = prev


class _GroupMean(torch.autograd.Function):
    """y = the mean of x over the group's ranks; each rank's cotangent of
    x is the mean of the ranks' cotangents of y."""

    @staticmethod
    def forward(ctx, x, mesh, axes, inv):
        from repro_torch.distribution.sharding import all_reduce_axes
        ctx.group = (mesh, axes, inv)
        return all_reduce_axes(x.clone(), mesh, axes) * inv

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distribution.sharding import all_reduce_axes
        mesh, axes, inv = ctx.group
        return all_reduce_axes(g.clone(), mesh, axes) * inv, None, None, None


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ambient data-parallel group's ranks
    (``data_parallel``); ``x`` itself outside one, or in a group of one."""
    group = getattr(_ctx, "group", None)
    if group is None:
        return x
    mesh, axes = group
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    if n == 1:
        return x
    return _GroupMean.apply(x, mesh, axes, 1.0 / n)


class _GroupMax(torch.autograd.Function):
    """y = the maximum of x over the group's ranks. The cotangent goes
    where the reference's ``max`` sends it, to the maximum: each rank's
    cotangent of x is the sum of the ranks' cotangents of y over the
    number of ranks whose x is the maximum, on a rank that holds it, and
    0 elsewhere (the sharded step sums the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from repro_torch.distribution.sharding import all_reduce_axes
        y = all_reduce_axes(x.clone(), mesh, axes, op="max")
        ctx.group = (mesh, axes)
        ctx.save_for_backward((x == y).to(x.dtype))
        return y

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distribution.sharding import all_reduce_axes
        mesh, axes = ctx.group
        held, = ctx.saved_tensors
        # one all-reduce: the cotangents' sum and the holders' count
        tot = all_reduce_axes(torch.stack([g.to(held.dtype), held]), mesh,
                              axes)
        return (tot[0] * held / tot[1]).to(g.dtype), None, None


def group_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a scalar) maximized over the ambient data-parallel group's
    ranks (``data_parallel``), differentiably; ``x`` itself outside one,
    or in a group of one."""
    group = getattr(_ctx, "group", None)
    if group is None:
        return x
    mesh, axes = group
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    if n == 1:
        return x
    return _GroupMax.apply(x, mesh, axes)
