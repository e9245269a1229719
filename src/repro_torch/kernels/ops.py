"""Dispatch wrappers: the full HDP attention pipeline on the card.

PyTorch counterpart of ``repro.kernels.ops``. ``hdp_attention_tpu``
keeps the reference's name and chains the co-processor's three stages
(paper Sec. IV-A):

1. the integer scout kernel (PE array + Sparsity Engine) -> theta, keep;
2. the early head gate from theta_head (vs tau_H);
3. the block-sparse FUM attention kernel on surviving blocks and heads.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and its
plain PyTorch version for CPU tensors, so the same code serves both.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import HDPConfig
from repro_torch.core.quant import calib_scale, quantize_fixed
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
from repro_torch.kernels.hdp_scout import hdp_scout
from repro_torch.kernels.ref import keep_mask_to_indices

F32 = torch.float32


def flash(q, k, v, *, causal: bool = True, block_q: int = 128,
          block_k: int = 128):
    return flash_attention(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)


def hdp_attention_tpu(q, k, v, cfg: HDPConfig, *,
                      max_keep: Optional[int] = None,
                      return_stats: bool = False):
    """Full HDP pipeline on kernel tiles. q,k,v [B,H,S,hd].

    max_keep: static cap on kept blocks per row (None -> exact, = nk).
    Returns (out [B,H,Sq,hd] fp32, stats dict or None)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    bq, bk = cfg.block_q, cfg.block_k
    nk = -(-Sk // bk)

    sq = calib_scale(q, cfg.int_bits, cfg.calib)
    sk = calib_scale(k, cfg.int_bits, cfg.calib)
    qq = quantize_fixed(q.to(F32) * sq, cfg.int_bits, cfg.frac_bits)
    kq = quantize_fixed(k.to(F32) * sk, cfg.int_bits, cfg.frac_bits)
    iq = torch.trunc(qq)
    ik = torch.trunc(kq)

    theta, keep, theta_head = hdp_scout(
        iq, ik, rho_b=cfg.rho_b, block_q=bq, block_k=bk, causal=cfg.causal)
    if not cfg.block_pruning:
        keep = torch.ones_like(keep)

    if cfg.normalize_head_score:
        if cfg.causal:
            n_valid = 0.5 * Sq * (Sq + 1) if Sq == Sk else Sq * Sk
        else:
            n_valid = Sq * Sk
        # a product with the reciprocal: XLA compiles the reference's
        # division by this constant so
        theta_head = theta_head * (1.0 / max(float(n_valid), 1.0))
    head_kept = (theta_head > cfg.tau_h) if cfg.head_pruning \
        else torch.ones_like(theta_head, dtype=torch.bool)

    mk = max_keep or nk
    kv_idx, counts = keep_mask_to_indices(keep, theta, mk)

    out = hdp_block_sparse_attention(
        qq, kq, v, kv_idx, counts, head_kept, causal=cfg.causal,
        approx=cfg.approx, block_q=bq, block_k=bk,
        score_scale=1.0 / (sq * sk))

    if not return_stats:
        return out, None
    stats = {
        "block_sparsity": 1.0 - keep.to(F32).sum() * (1.0 / keep.numel()),
        "head_sparsity": 1.0 - head_kept.to(F32).sum()
        * (1.0 / head_kept.numel()),
        "kept_blocks_per_row": counts.to(F32).sum()
        * (1.0 / counts.numel()),
        "theta_head": theta_head,
        "total_blocks": keep.shape[-2] * keep.shape[-1],
    }
    return out, stats
