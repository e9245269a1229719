"""Block importance, row-balanced thresholds and keep masks (Alg. 2 lines
6-17), PyTorch counterpart of ``repro.core.blocking``.

Every reduction runs in fp32 in the same order as the JAX reference:
the keep mask compares theta with a threshold built from
``rho*max + (1-rho)*mean``, so a one-ULP difference in the threshold
would flip a page.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pooled_block_theta(scores: torch.Tensor, valid: torch.Tensor,
                       block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool a [..., q, Sk] score slab into ONE row of Sk/block_k blocks.

    The whole q extent is one block row (decode-shaped pooling: with a
    block-paged KV cache these blocks ARE the cache pages). ``valid`` is
    a broadcastable bool mask over [..., q, Sk]. Returns (theta [..., nk]
    f32 abs-sum importances, bvalid [..., nk] blocks with any valid
    position)."""
    s = torch.where(valid, scores, torch.zeros((), dtype=scores.dtype,
                                               device=scores.device))
    *lead, q, sk = s.shape
    theta = s.reshape(*lead, q, sk // block_k, block_k).abs().sum(dim=(-3, -1))
    *vlead, vq, _ = valid.shape
    bvalid = valid.reshape(*vlead, vq, sk // block_k, block_k).any(dim=-1) \
        .any(dim=-2)
    return theta, bvalid


def row_threshold(theta: torch.Tensor, rho_b,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Theta_i per row of blocks (Alg. 2 line 15), both rho_B branches:
    rho*max + (1-rho)*mean for rho >= 0, -rho*min + (1+rho)*mean below.

    theta: [..., R, C]; valid: optional bool [..., R, C] marking blocks
    that take part in the statistics. Returns [..., R, 1]."""
    # filled in on the device (not copied from the host): CUDA graph
    # capture of the decode step records it
    rho = torch.full((), rho_b, dtype=theta.dtype, device=theta.device)
    if valid is None:
        tmin = theta.amin(dim=-1, keepdim=True)
        tmax = theta.amax(dim=-1, keepdim=True)
        # sum * (1/count): XLA compiles jnp.mean's division by a constant
        # count into this product, which rounds differently from sum/count
        tmean = theta.sum(dim=-1, keepdim=True) * (1.0 / theta.shape[-1])
    else:
        big = torch.finfo(theta.dtype).max
        tmin = torch.where(valid, theta, big).amin(dim=-1, keepdim=True)
        tmax = torch.where(valid, theta, -big).amax(dim=-1, keepdim=True)
        cnt = valid.sum(dim=-1, keepdim=True).to(theta.dtype)
        cnt = torch.clamp(cnt, min=1.0)
        tmean = torch.where(valid, theta, 0.0).sum(dim=-1, keepdim=True) / cnt
    pos = rho * tmax + (1.0 - rho) * tmean
    neg = -rho * tmin + (1.0 + rho) * tmean
    return torch.where(rho >= 0, pos, neg)


def block_keep_mask(theta: torch.Tensor, threshold: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask_i^j = 0 iff theta_j < Theta_i (Alg. 2 line 16)."""
    keep = theta >= threshold
    if valid is not None:
        keep = keep & valid
    return keep


def block_abs_sum(scores: torch.Tensor, block_q: int,
                  block_k: int) -> torch.Tensor:
    """theta_j = sum |x| over each block -> [..., Lq/bq, Lk/bk]."""
    *lead, lq, lk = scores.shape
    if lq % block_q or lk % block_k:
        raise ValueError(f"({lq},{lk}) not divisible by block "
                         f"({block_q},{block_k})")
    r = scores.reshape(*lead, lq // block_q, block_q, lk // block_k, block_k)
    return r.abs().sum(dim=(-3, -1))


def expand_block_mask(mask: torch.Tensor, block_q: int,
                      block_k: int) -> torch.Tensor:
    """[..., R, C] block mask -> [..., R*bq, C*bk] element mask."""
    return mask.repeat_interleave(block_q, dim=-2) \
        .repeat_interleave(block_k, dim=-1)


def causal_element_mask(lq: int, lk: int, q_offset: int = 0,
                        device=None) -> torch.Tensor:
    q = torch.arange(lq, device=device) + q_offset
    k = torch.arange(lk, device=device)
    return q[:, None] >= k[None, :]


_NEG = -1e30   # instead of -inf, so a fully masked row stays NaN-free


def masked_softmax(scores: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row softmax with exclusion; fully pruned rows give zeros."""
    if keep is not None:
        scores = torch.where(keep, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if keep is not None:
        e = torch.where(keep, e, 0.0)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(s, min=1e-30)
