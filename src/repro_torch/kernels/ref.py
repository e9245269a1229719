"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each kernel against
its plain version on the card. They repeat the kernels' arithmetic (same
masks, same online softmax); they are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import decode_pool, quantize_fixed

F32 = torch.float32
NEG = -1e30


def hdp_paged_fum_decode_ref(qq, k_pool, v_pool, page_ids, logical, counts,
                             keep, kv_len, *, approx: bool = True,
                             int_bits: int = 4, frac_bits: int = 12,
                             k_scale=None, v_scale=None) -> torch.Tensor:
    """Gather-free FUM decode, as a loop over each row's kept pages.

    qq [B,N,G,Sq,hd] fixed-grid queries; k/v_pool [P,ps,N,hd] page pools,
    int8 codes with ``k_scale``/``v_scale`` [P,N] or fp32 values without;
    page_ids/logical [B,mk] int32 pool id / logical slot of each kept
    page (ascending, scratch-0-padded past ``counts``); counts [B]; keep
    [B,mk,N,G,Sq] int32; kv_len [B] valid extent of query row 0 (row j
    extends it by j). Only pages in ``page_ids[b, :counts[b]]`` are read.

    Scores are QQ·Kᵀ − frac(QQ)·frac(K)ᵀ over 1/√hd, column c of row r
    counts where ``c < kv_len + r % Sq`` and keep is set, and an online
    softmax (NEG = -1e30, invalid p = 0, l floored at 1e-30) runs across
    pages. int8 K and V decode as codes × scale, code -128 to NaN; an fp32
    pool's K is snapped to the fixed-point grid. Returns [B,N,G,Sq,hd]
    (head gate applied by the caller)."""
    B, N, G, Sq, hd = qq.shape
    ps = k_pool.shape[1]
    R = G * Sq
    scale = 1.0 / (hd ** 0.5)
    quantized = k_scale is not None
    q = qq.reshape(B, N, R, hd).to(F32)
    fq = q - torch.trunc(q)
    sq_idx = torch.arange(R, device=qq.device) % Sq
    cols_in_page = torch.arange(ps, device=qq.device)
    out = torch.empty((B, N, R, hd), dtype=F32, device=qq.device)
    for b, cnt in enumerate(counts.tolist()):
        m = torch.full((N, R), NEG, dtype=F32, device=qq.device)
        l = torch.zeros((N, R), dtype=F32, device=qq.device)
        acc = torch.zeros((N, R, hd), dtype=F32, device=qq.device)
        for j in range(cnt):
            pid = page_ids[b, j].long()
            if quantized:
                kq = decode_pool(k_pool[pid], k_scale[pid][None, :, None])
                v = decode_pool(v_pool[pid], v_scale[pid][None, :, None])
            else:
                kq = quantize_fixed(k_pool[pid].to(F32), int_bits, frac_bits)
                v = v_pool[pid].to(F32)
            s = torch.einsum("nrh,pnh->nrp", q[b], kq)
            if approx:
                fk = kq - torch.trunc(kq)
                s = s - torch.einsum("nrh,pnh->nrp", fq[b], fk)
            s = s * scale
            cols = logical[b, j] * ps + cols_in_page             # [ps]
            valid = cols[None, None, :] < (kv_len[b] + sq_idx)[None, :, None]
            valid = valid & (keep[b, j].reshape(N, R) > 0)[:, :, None]
            s = torch.where(valid, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum("nrp,pnh->nrh", p, v)
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, N, G, Sq, hd).to(qq.dtype)
