"""Top-K block pruning baseline (paper Sec. V-A2(a), Fig. 7), PyTorch
counterpart of ``repro.core.topk``.

The paper's comparison oracle: per row of blocks, keep exactly the top-k
blocks by full-precision importance. HDP's threshold rule approximates
this without sorting hardware; the Fig. 7 analog measures how well.
Blocks tied with the k-th largest are all kept, as in the reference
(its threshold is the k-th value of an ascending sort, not a top-k
selection, so no tie order enters).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import blocking


def topk_block_mask(scores: torch.Tensor, block_q: int, block_k: int,
                    keep_ratio: float,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep the top round(keep_ratio * C) blocks (at least one) per block
    row. ``scores``: full-precision attention scores [..., Lq, Lk];
    returns a bool keep mask on block geometry [..., R, C]."""
    theta = blocking.block_abs_sum(scores, block_q, block_k)
    c = theta.shape[-1]
    k = max(1, int(round(keep_ratio * c)))
    if valid is not None:
        theta = torch.where(valid, theta, float("-inf"))
    # threshold: the k-th largest of each row
    kth = torch.sort(theta, dim=-1).values[..., c - k:c - k + 1]
    keep = theta >= kth
    if valid is not None:
        keep = keep & valid
    return keep


def topk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   block_q: int, block_k: int, keep_ratio: float, *,
                   causal: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention with Top-K block pruning; returns (out, keep)."""
    hd = torch.full((), q.shape[-1], dtype=q.dtype, device=q.device)
    scores = torch.einsum("...qd,...kd->...qk", q, k) / torch.sqrt(hd)
    valid = None
    if causal:
        valid = blocking.causal_block_valid(q.shape[-2], k.shape[-2],
                                            block_q, block_k,
                                            device=q.device)
    keep = topk_block_mask(scores, block_q, block_k, keep_ratio, valid)
    keep_elem = blocking.expand_block_mask(keep, block_q, block_k)
    if causal:
        keep_elem = keep_elem & blocking.causal_element_mask(
            q.shape[-2], k.shape[-2], device=q.device)
    prob = blocking.masked_softmax(scores, keep_elem)
    return torch.einsum("...qk,...kd->...qd", prob, v), keep


def mask_agreement(mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """IoU of two keep masks: the Fig. 7 "does HDP track Top-K" metric."""
    a = mask_a.to(torch.float32)
    b = mask_b.to(torch.float32)
    inter = (a * b).sum()
    union = torch.clamp(torch.maximum(a, b).sum(), min=1.0)
    return inter / union
