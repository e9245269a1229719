"""Hybrid Dynamic Pruning attention: the faithful Algorithm 2, the
batched fast path, and the building blocks the serving path uses.
PyTorch counterpart of ``repro.core.hdp``.

Two implementations with identical semantics, on one attention head of
shape [..., L, d_h] (every leading index is one "head" for the head
gate):

* :func:`hdp_attention_reference`: the paper's Algorithm 2 term by term
  (Integer_atten + Frac1 + Frac2, the mask algebra as array ops), the
  oracle of the tests;
* :func:`hdp_attention`: the fast path, through the identity
  ``IQ.IK^T + IQ.FK^T + FQ.IK^T == QK^T - FQ.FK^T``.

Both take the softmax the config names: the exact one, or with
``approx_softmax`` the HDP softmax unit's polynomial exp and
linear-approximation reciprocal (``blocking.approx_softmax``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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


@dataclasses.dataclass
class HDPStats:
    """Diagnostics of an HDP attention call (tensors)."""

    keep_blocks: torch.Tensor     # bool [..., R, C]
    head_kept: torch.Tensor       # bool [...]
    theta: torch.Tensor           # [..., R, C] block importances
    theta_head: torch.Tensor      # [...] head importances
    threshold: torch.Tensor       # [..., R, 1] row thresholds
    block_sparsity: torch.Tensor  # scalar: pruned blocks in kept heads
    head_sparsity: torch.Tensor   # scalar: pruned heads
    net_sparsity: torch.Tensor    # scalar: the Fig. 10 accounting


def _pad_to_blocks(x: torch.Tensor, bq: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % bq
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _inv_sqrt_hd(hd: int) -> float:
    """1/sqrt(hd) in fp32: the compiled reference divides the scores by
    the constant sqrt(hd) as a product with this reciprocal."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _scout_and_mask(iq, ik, cfg: HDPConfig, lq, lk, q_offset, kv_len=None):
    """Integer scout product -> block statistics -> (integer scores,
    element validity, block validity, theta, threshold, keep_blocks,
    theta_head, head_kept), all on the padded block geometry (the caller
    crops)."""
    bq, bk = cfg.block_q, cfg.block_k
    dev = iq.device
    integer_atten = torch.einsum("...qd,...kd->...qk", iq, ik)

    # which entries are valid: causal, and/or bounded by the KV length
    elem_valid = None
    if cfg.causal:
        elem_valid = blocking.causal_element_mask(
            iq.shape[-2], ik.shape[-2], q_offset, device=dev)
    if kv_len is not None:
        kmask = (torch.arange(ik.shape[-2], device=dev) < kv_len)[None, :]
        elem_valid = kmask if elem_valid is None else elem_valid & kmask
    if iq.shape[-2] - lq or ik.shape[-2] - lk:
        pv = torch.zeros((iq.shape[-2], ik.shape[-2]), dtype=torch.bool,
                         device=dev)
        pv[:lq, :lk] = True
        elem_valid = pv if elem_valid is None else elem_valid & pv

    if elem_valid is not None:
        theta_src = torch.where(elem_valid, integer_atten, 0.0)
        block_valid = blocking.block_abs_sum(
            elem_valid.to(integer_atten.dtype), bq, bk) > 0
    else:
        theta_src = integer_atten
        block_valid = None

    theta = blocking.block_abs_sum(theta_src, bq, bk)
    if cfg.block_pruning:
        thresh = blocking.row_threshold(theta, cfg.rho_b, block_valid)
        keep = blocking.block_keep_mask(theta, thresh, block_valid)
    else:
        thresh = torch.zeros_like(theta[..., :1])
        keep = torch.ones_like(theta, dtype=torch.bool) \
            if block_valid is None else block_valid

    # head importance: the absolute sum over the whole integer map (line 10)
    if block_valid is not None:
        theta_head = torch.where(block_valid, theta, 0.0).sum(dim=(-2, -1))
        n_valid = elem_valid.to(torch.float32).sum()
    else:
        theta_head = theta.sum(dim=(-2, -1))
        n_valid = torch.full((), float(lq * lk), device=dev)
    if cfg.normalize_head_score:
        theta_head = theta_head / torch.clamp(n_valid, min=1.0)
    if cfg.head_pruning:
        head_kept = theta_head > cfg.tau_h  # line 19: proceed iff theta > tau
    else:
        head_kept = torch.ones_like(theta_head, dtype=torch.bool)
    return (integer_atten, elem_valid, block_valid, theta, thresh, keep,
            theta_head, head_kept)


def _finish(scores, keep_elem, head_kept, v, cfg: HDPConfig):
    softmax = blocking.approx_softmax if cfg.approx_softmax \
        else blocking.masked_softmax
    prob = softmax(scores, keep_elem)
    out = torch.einsum("...qk,...kd->...qd", prob, v)
    gate = head_kept[..., None, None].to(out.dtype)
    return out * gate  # line 33: a pruned head's result is 0


def hdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: HDPConfig, *, q_offset: int = 0,
                  kv_len: Optional[torch.Tensor] = None,
                  return_stats: bool = True):
    """Batched HDP attention (the fast path) on [..., L, d_h] tensors.

    q_offset: absolute position of q[..., 0, :] (decode); kv_len: an
    optional dynamic bound on the valid KV. Returns (out, HDPStats or
    None)."""
    if not cfg.enabled:
        scores = torch.einsum("...qd,...kd->...qk", q, k) \
            * _inv_sqrt_hd(q.shape[-1])
        keep = None
        if cfg.causal:
            keep = blocking.causal_element_mask(q.shape[-2], k.shape[-2],
                                                q_offset, device=q.device)
        out = torch.einsum("...qk,...kd->...qd",
                           blocking.masked_softmax(scores, keep), v)
        return out, None

    lq, lk = q.shape[-2], k.shape[-2]
    qp = _pad_to_blocks(q, cfg.block_q, -2)
    kp = _pad_to_blocks(k, cfg.block_k, -2)
    vp = _pad_to_blocks(v, cfg.block_k, -2)

    sq, qq, iq, fq = calibrated_split(qp, cfg)
    sk, kq, ik, fk = calibrated_split(kp, cfg)

    (_, elem_valid, _, theta, thresh, keep, theta_head,
     head_kept) = _scout_and_mask(iq, ik, cfg, lq, lk, q_offset, kv_len)

    # approx = QK^T - FQ.FK^T (== Integer + Frac1 + Frac2 exactly);
    # 1/(s_q*s_k) maps the scores back from the calibrated domain
    scores = torch.einsum("...qd,...kd->...qk", qq, kq)
    if cfg.approx:
        scores = scores - torch.einsum("...qd,...kd->...qk", fq, fk)
    scores = scores / (sq * sk).to(scores.dtype)
    scores = scores * _inv_sqrt_hd(q.shape[-1])

    keep_elem = blocking.expand_block_mask(keep, cfg.block_q, cfg.block_k)
    if elem_valid is not None:
        keep_elem = keep_elem & elem_valid

    out = _finish(scores, keep_elem, head_kept, vp, cfg)[..., :lq, :]

    stats = None
    if return_stats:
        block_valid = None
        if elem_valid is not None:
            block_valid = blocking.block_abs_sum(
                elem_valid.to(torch.float32), cfg.block_q, cfg.block_k) > 0
        bsp, hsp, net = blocking.net_sparsity(
            keep, head_kept[..., None, None], block_valid)
        stats = HDPStats(keep, head_kept, theta, theta_head, thresh, bsp,
                         hsp, net)
    return out, stats


def hdp_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, cfg: HDPConfig, *,
                            q_offset: int = 0):
    """The literal Algorithm 2: the three-term approximation, explicit
    mask algebra. Materializing; the oracle of the tests."""
    lq, lk = q.shape[-2], k.shape[-2]
    qp = _pad_to_blocks(q, cfg.block_q, -2)
    kp = _pad_to_blocks(k, cfg.block_k, -2)
    vp = _pad_to_blocks(v, cfg.block_k, -2)
    sq, _, iq, fq = calibrated_split(qp, cfg)
    sk, _, ik, fk = calibrated_split(kp, cfg)

    (integer_atten, elem_valid, _, theta, thresh, keep, theta_head,
     head_kept) = _scout_and_mask(iq, ik, cfg, lq, lk, q_offset)

    # lines 19-28: the fractional terms only where Mask == 1 (computed
    # densely and masked: masked entries leave the softmax anyway)
    frac1 = torch.einsum("...qd,...kd->...qk", iq, fk)
    frac2 = torch.einsum("...qd,...kd->...qk", fq, ik)
    approximation = integer_atten + frac1 + frac2
    if not cfg.approx:
        approximation = approximation + torch.einsum(
            "...qd,...kd->...qk", fq, fk)
    approximation = approximation / (sq * sk).to(approximation.dtype)
    scores = approximation * _inv_sqrt_hd(q.shape[-1])

    keep_elem = blocking.expand_block_mask(keep, cfg.block_q, cfg.block_k)
    if elem_valid is not None:
        keep_elem = keep_elem & elem_valid
    out = _finish(scores, keep_elem, head_kept, vp, cfg)[..., :lq, :]
    stats = HDPStats(keep, head_kept, theta, theta_head, thresh,
                     *blocking.net_sparsity(keep, head_kept[..., None, None],
                                            None))
    return out, stats


def dense_attention_reference(q, k, v, *, causal=False, q_offset=0):
    """Exact (unquantized, unpruned) attention: the fidelity yardstick."""
    scores = torch.einsum("...qd,...kd->...qk", q, k) \
        * _inv_sqrt_hd(q.shape[-1])
    keep = None
    if causal:
        keep = blocking.causal_element_mask(q.shape[-2], k.shape[-2],
                                            q_offset, device=q.device)
    prob = blocking.masked_softmax(scores, keep)
    return torch.einsum("...qk,...kd->...qd", prob, v)
