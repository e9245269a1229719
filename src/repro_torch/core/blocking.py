"""Block importance, row-balanced thresholds and keep masks (Alg. 2 lines
6-17), and the HDP softmax unit's polynomial softmax; PyTorch
counterpart of ``repro.core.blocking``.

Every reduction runs in fp32 in the same order as the JAX reference:
the keep mask compares theta with a threshold built from
``rho*max + (1-rho)*mean``, so a one-ULP difference in the threshold
would flip a page.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def block_sum(scores: torch.Tensor, block_q: int,
              block_k: int) -> torch.Tensor:
    """Plain block sum (near-zero statistics) -> [..., Lq/bq, Lk/bk]."""
    *lead, lq, lk = scores.shape
    r = scores.reshape(*lead, lq // block_q, block_q, lk // block_k, block_k)
    return r.sum(dim=(-3, -1))


def expand_block_mask(mask: torch.Tensor, block_q: int,
                      block_k: int) -> torch.Tensor:
    """[..., R, C] block mask -> [..., R*bq, C*bk] element mask."""
    return mask.repeat_interleave(block_q, dim=-2) \
        .repeat_interleave(block_k, dim=-1)


def causal_block_valid(lq: int, lk: int, block_q: int, block_k: int,
                       q_offset: int = 0, device=None) -> torch.Tensor:
    """Blocks with at least one causally visible (q >= k) entry; q_offset
    shifts the query positions (decode: the cache length). Returns bool
    [lq/bq, lk/bk]."""
    qb = torch.arange(lq // block_q, device=device) * block_q \
        + (block_q - 1) + q_offset            # last q row of each block
    kb = torch.arange(lk // block_k, device=device) * block_k
    return qb[:, None] >= kb[None, :]


def causal_element_mask(lq: int, lk: int, q_offset: int = 0,
                        device=None) -> torch.Tensor:
    q = torch.arange(lq, device=device) + q_offset
    k = torch.arange(lk, device=device)
    return q[:, None] >= k[None, :]


_NEG = -1e30   # instead of -inf, so a fully masked row stays NaN-free


def apply_score_mask(scores: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Exclusion semantics: pruned entries leave the softmax entirely."""
    return torch.where(keep, scores, _NEG)


def masked_softmax(scores: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row softmax with exclusion; fully pruned rows give zeros."""
    if keep is not None:
        scores = apply_score_mask(scores, keep)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if keep is not None:
        e = torch.where(keep, e, 0.0)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(s, min=1e-30)


# ---------------------------------------------------------------------------
# The HDP softmax unit (paper Sec. IV-E): a 2nd-order polynomial exponent
# with range reduction, and a reciprocal by linear approximation.
# ---------------------------------------------------------------------------

_LN2 = 0.6931471805599453
#: 1/ln 2 in fp32: XLA compiles the reference's division by the constant
#: ln 2 into a product with this reciprocal, which rounds differently
#: from the division (z would flip at the boundaries)
_INV_LN2 = float(np.float32(1.0) / np.float32(_LN2))


def poly_exp(x: torch.Tensor) -> torch.Tensor:
    """I-BERT-style 2nd-order polynomial exp for x <= 0:
    e^x = 2^(-z) * e^r with r in (-ln2, 0], e^r ~ 0.3585 (r+1.353)^2 +
    0.344."""
    x = torch.clamp(x, max=0.0)
    z = torch.floor(-x * _INV_LN2)
    r = x + z * _LN2
    p = 0.3585 * (r + 1.353) ** 2 + 0.344
    return p * torch.exp2(-z)


def linear_reciprocal(s: torch.Tensor, newton_iters: int = 2) -> torch.Tensor:
    """Reciprocal by a linear approximation on the mantissa and Newton
    steps. For s = m * 2^e with m in [1, 2): 1/m ~ 24/17 - 8/17*m (the
    Newton-Raphson division seed rescaled to [1, 2)), refined by
    y <- y * (2 - s*y), as a cheap fixed-point divider does. The seed is
    continuous across powers of two (16/17 at m = 1 and at m = 2 one
    exponent down), so an exponent that a ``log2`` one ulp off puts on
    the other side of a power of two gives the same reciprocal up to
    rounding."""
    s = torch.clamp(s, min=1e-30)
    e = torch.floor(torch.log2(s))
    m = s * torch.exp2(-e)
    y = (24.0 / 17.0 - 8.0 / 17.0 * m) * torch.exp2(-e)
    for _ in range(newton_iters):
        y = y * (2.0 - s * y)
    return y


def approx_softmax(scores: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax as the HDP softmax unit computes it (polynomial exp and
    linear-approximation reciprocal), with exclusion."""
    if keep is not None:
        scores = apply_score_mask(scores, keep)
    m = scores.amax(dim=-1, keepdim=True)
    e = poly_exp(scores - m)
    if keep is not None:
        e = torch.where(keep, e, 0.0)
    s = e.sum(dim=-1, keepdim=True)
    return e * linear_reciprocal(s)


def net_sparsity(keep_blocks: torch.Tensor, head_kept: torch.Tensor,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(block sparsity in kept heads, head sparsity, net sparsity).

    Net sparsity counts a block as skipped if its head was pruned OR the
    block itself was (the paper's Fig. 10 accounting); every fraction is
    over the valid (causally reachable) blocks."""
    kb = keep_blocks.to(torch.float32)
    hk = head_kept.to(torch.float32)          # [..., 1, 1]-broadcastable
    if valid is None:
        valid_f = torch.ones_like(kb)
    else:
        valid_f = valid.to(torch.float32) * torch.ones_like(kb)
    total = torch.clamp(valid_f.sum(), min=1.0)
    kept_and_head = kb * hk * valid_f
    block_pruned = (valid_f - kb * valid_f) * hk
    head_pruned = valid_f * (1.0 - hk)
    block_sp = block_pruned.sum() / torch.clamp((valid_f * hk).sum(), min=1.0)
    head_sp = head_pruned.sum() / total
    net = 1.0 - kept_and_head.sum() / total
    return block_sp, head_sp, net
