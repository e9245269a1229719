"""HDP building blocks for the serving path: calibrated fixed-point split
and the decode-shaped integer scout. PyTorch counterpart of the parts of
``repro.core.hdp`` that serving uses."""
from __future__ import annotations

import torch

from repro_torch.core import blocking
from repro_torch.core.config import HDPConfig
from repro_torch.core.quant import calib_scale, quantize_and_split


def calibrated_split(x: torch.Tensor, cfg: HDPConfig):
    """(scale, xq, I, F) with x*scale snapped to the fixed-point grid."""
    s = calib_scale(x, cfg.int_bits, cfg.calib)
    xq, i, f = quantize_and_split(x * s.to(x.dtype), cfg.int_bits,
                                  cfg.frac_bits)
    return s, xq, i, f


def decode_scout(int_scores: torch.Tensor, valid: torch.Tensor,
                 cfg: HDPConfig, per_query: bool = False):
    """Decode-shaped integer scout: one block row per head over KV pages.

    ``int_scores`` [..., Sq, Sk] are integer-part scores of a small
    decode query group; Sk is a multiple of ``cfg.block_k``. The query
    extent pools into one row of Sk/block_k blocks, which with a
    block-paged cache ARE the pages, so the keep mask doubles as the
    page fetch list (Fetch-Upon-Mask). ``valid`` is a broadcastable bool
    mask [..., Sq, Sk].

    ``per_query`` keeps the Sq axis instead of pooling it: each query
    row gets its own block row and head gate (the speculative-verify
    shape), and every output below gains a trailing Sq axis before nk.

    Returns (keep [..., nk], bvalid [..., nk], theta [..., nk],
    theta_head [...], head_kept [...])."""
    if per_query:
        int_scores = int_scores[..., :, None, :]
        valid = valid[..., :, None, :]
    theta, bvalid = blocking.pooled_block_theta(int_scores, valid,
                                                cfg.block_k)
    if cfg.block_pruning:
        thr = blocking.row_threshold(theta, cfg.rho_b, bvalid)
        keep = blocking.block_keep_mask(theta, thr, bvalid)
    else:
        keep = bvalid.expand(theta.shape)
    theta_head = torch.where(bvalid, theta, 0.0).sum(-1)
    if cfg.normalize_head_score:
        n_valid = valid.sum(dim=(-2, -1)).to(torch.float32)
        theta_head = theta_head / torch.clamp(n_valid, min=1.0)
    head_kept = (theta_head > cfg.tau_h) if cfg.head_pruning \
        else torch.ones_like(theta_head, dtype=torch.bool)
    return keep, bvalid, theta, theta_head, head_kept
