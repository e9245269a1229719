"""Distributed-optimization helpers.

Gradient compression: an identity whose backward rounds an fp32
cotangent through bf16. Placed at parameter use-sites, it makes autograd
*produce* bf16-valued gradients, so a data-parallel all-reduce would move
half the bytes. The optimizer upcasts back to fp32 before the update
(the error is bounded by bf16 rounding of the *summed* gradient).
PyTorch counterpart of ``repro.distribution.collectives``.
"""
from __future__ import annotations

import torch

from repro_torch.common import tree


class _CompressGradsBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
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
