"""Plain PyTorch versions of the hand-written kernels, and the oracles.

Two kinds of function live here:

* the **plain versions** (``*_plain``, and ``hdp_paged_fum_decode_ref``
  of the first slice) repeat each kernel's arithmetic as its Pallas body
  states it (same tiles, masks and online softmax). A wrapper runs its
  plain version for CPU tensors, the CPU tests compare them with the JAX
  kernels, and ``chip_smoke.py`` holds each kernel against its plain
  version on the card. They are no yardstick of speed;
* the **oracles** ``flash_attention_ref``, ``hdp_scout_ref`` and
  ``hdp_block_attn_ref`` (the counterparts of ``repro/kernels/ref.py``)
  compute the same functions densely from ``core.blocking``, plus
  ``keep_mask_to_indices``, which turns a keep mask into the block
  kernel's per-row lists.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import blocking
from repro_torch.core.quant import decode_pool, int_frac_split, quantize_fixed

F32 = torch.float32
NEG = -1e30
BIG = 1e30


def hdp_paged_fum_decode_ref(qq, k_pool, v_pool, page_ids, logical, counts,
                             keep, kv_len, *, approx: bool = True,
                             int_bits: int = 4, frac_bits: int = 12,
                             k_scale=None, v_scale=None,
                             partial: bool = False, dtype=F32):
    """Gather-free FUM decode, as a loop over each row's kept pages.

    qq [B,N,G,Sq,hd] fixed-grid queries; k/v_pool [P,ps,N,hd] page pools,
    int8 K codes and int8 or float8_e4m3fn V with ``k_scale``/``v_scale``
    [P,N], or unquantized (fp32, bf16) values without;
    page_ids/logical [B,mk] int32 pool id / logical slot of each kept
    page (ascending, scratch-0-padded past ``counts``); counts [B]; keep
    [B,mk,N,G,Sq] int32; kv_len [B] valid extent of query row 0 (row j
    extends it by j). Only pages in ``page_ids[b, :counts[b]]`` are read.

    Scores are QQ·Kᵀ − frac(QQ)·frac(K)ᵀ over 1/√hd, column c of row r
    counts where ``c < kv_len + r % Sq`` and keep is set, and an online
    softmax (NEG = -1e30, invalid p = 0, l floored at 1e-30) runs across
    pages. int8 K and V decode as codes × scale, code -128 to NaN, fp8 V
    as its value × scale; an unquantized pool's K is snapped to the
    fixed-point grid, and p is rounded to its dtype before p·V (the TPU
    kernel's ``p.astype(v.dtype)``). Returns [B,N,G,Sq,hd]
    (head gate applied by the caller); with ``partial`` the softmax state
    instead, (acc [B,N,G,Sq,hd] unnormalized, m and l [B,N,G,Sq]), which
    the kernel's blocks merge when they split a row's pages. ``dtype``
    is the arithmetic's (float64 evaluates the same function with less
    rounding, to measure how far fp32 sum order moves an output); the
    result is in qq's dtype."""
    B, N, G, Sq, hd = qq.shape
    ps = k_pool.shape[1]
    R = G * Sq
    scale = 1.0 / (hd ** 0.5)
    quantized = k_scale is not None
    q = qq.reshape(B, N, R, hd).to(dtype)
    fq = q - torch.trunc(q)
    sq_idx = torch.arange(R, device=qq.device) % Sq
    cols_in_page = torch.arange(ps, device=qq.device)
    out = torch.empty((B, N, R, hd), dtype=dtype, device=qq.device)
    ms, ls = torch.empty((2, B, N, R), dtype=dtype, device=qq.device)
    for b, cnt in enumerate(counts.tolist()):
        m = torch.full((N, R), NEG, dtype=dtype, device=qq.device)
        l = torch.zeros((N, R), dtype=dtype, device=qq.device)
        acc = torch.zeros((N, R, hd), dtype=dtype, device=qq.device)
        for j in range(cnt):
            pid = page_ids[b, j].long()
            if quantized:
                # codes x a power-of-two or fp8 scale: exact in fp32
                kq = decode_pool(k_pool[pid],
                                 k_scale[pid][None, :, None]).to(dtype)
                vs = v_scale[pid][None, :, None]
                v = (decode_pool(v_pool[pid], vs)
                     if v_pool.dtype == torch.int8
                     else v_pool[pid].to(F32) * vs).to(dtype)
            else:
                kq = quantize_fixed(k_pool[pid].to(dtype), int_bits,
                                    frac_bits)
                v = v_pool[pid].to(dtype)
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
            if not quantized:
                p = p.to(v_pool.dtype).to(dtype)
            acc = acc * corr[..., None] + torch.einsum("nrp,pnh->nrh", p, v)
        if partial:
            out[b], ms[b], ls[b] = acc, m, l
        else:
            out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    if partial:
        return (out.reshape(B, N, G, Sq, hd), ms.reshape(B, N, G, Sq),
                ls.reshape(B, N, G, Sq))
    return out.reshape(B, N, G, Sq, hd).to(qq.dtype)


# ----------------------------------------------------------------- oracles
def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q,k,v [B,H,S,hd] -> [B,H,S,hd], exact softmax attention."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * scale
    if causal:
        mask = blocking.causal_element_mask(q.shape[2], k.shape[2],
                                            device=q.device)
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def hdp_scout_ref(iq, ik, *, block_q: int, block_k: int, rho_b: float,
                  causal: bool = True):
    """Integer scout oracle. iq/ik [B,H,S,hd] integer-valued floats, S a
    multiple of the blocks. Returns (theta [B,H,nq,nk], keep bool,
    theta_head [B,H])."""
    s = torch.einsum("bhqd,bhkd->bhqk", iq.to(F32), ik.to(F32))
    lq, lk = iq.shape[2], ik.shape[2]
    bvalid = None
    if causal:
        valid = blocking.causal_element_mask(lq, lk, device=iq.device)
        s = torch.where(valid, s, 0.0)
        bvalid = blocking.block_abs_sum(valid.to(F32), block_q, block_k) > 0
    theta = blocking.block_abs_sum(s, block_q, block_k)
    thr = blocking.row_threshold(theta, rho_b, bvalid)
    keep = blocking.block_keep_mask(theta, thr, bvalid)
    theta_head = torch.where(bvalid, theta, 0.0).sum((-2, -1)) if causal \
        else theta.sum((-2, -1))
    return theta, keep, theta_head


def hdp_block_attn_ref(q, k, v, keep, *, block_q: int, block_k: int,
                       causal: bool = True, approx: bool = True,
                       head_kept=None) -> torch.Tensor:
    """Block-sparse approximate attention oracle. q,k,v [B,H,S,hd]; keep
    bool [B,H,nq,nk]. Scores on surviving blocks are QK^T - FQ FK^T;
    pruned blocks leave the softmax; pruned heads (head_kept [B,H] bool)
    output 0."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf = q.to(F32), k.to(F32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if approx:
        _, fq = int_frac_split(qf)
        _, fk = int_frac_split(kf)
        s = s - torch.einsum("bhqd,bhkd->bhqk", fq, fk)
    s = s * scale
    keep_e = blocking.expand_block_mask(keep, block_q, block_k)
    if causal:
        keep_e = keep_e & blocking.causal_element_mask(
            q.shape[2], k.shape[2], device=q.device)
    p = blocking.masked_softmax(s, keep_e)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32))
    if head_kept is not None:
        out = out * head_kept[..., None, None].to(F32)
    return out.to(q.dtype)


def f32_scalar(x, device) -> torch.Tensor:
    """A number (or tensor) as an fp32 tensor on ``device``. A number is
    filled in on the device rather than copied from the host, so CUDA
    graph capture can record it."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=F32, device=device)
    return torch.full((), float(x), dtype=F32, device=device)


def keep_mask_to_indices(keep, theta, max_keep: int):
    """Keep mask -> (indices [.., nq, max_keep] int32, counts [.., nq]).

    Rows keeping more than ``max_keep`` blocks drop their lowest-theta
    extras; ties keep the lower block (a stable sort, as ``jnp.argsort``
    is). Kept indices come out ascending; padding points at block 0."""
    score = torch.where(keep, theta.to(F32), -math.inf)
    order = torch.argsort(-score, dim=-1, stable=True)[..., :max_keep]
    sorted_keep = torch.gather(keep, -1, order)
    counts = sorted_keep.sum(-1).to(torch.int32)
    big = torch.iinfo(torch.int32).max
    key = torch.where(sorted_keep, order, big)
    idx = torch.sort(key, dim=-1).values
    ar = torch.arange(idx.shape[-1], device=keep.device)
    idx = torch.where(ar < counts[..., None], idx, 0)
    return idx.to(torch.int32), counts


# --------------------------------------------------- plain kernel versions
def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad_seq(x, target: int):
    """Zero-pad axis 2 of [B,H,S,hd] to ``target``."""
    pad = target - x.shape[2]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros(*x.shape[:2], pad, x.shape[3])], dim=2)


def scout_coefficients(rho_b: float) -> Tuple[bool, float, float]:
    """(use_max, c_ext, c_mean) of the row threshold, each rounded once to
    fp32 from the Python double, as the Pallas body's constants are:
    rho >= 0: c_ext*max + c_mean*mean; rho < 0: c_ext*min + c_mean*mean."""
    if rho_b >= 0:
        return True, float(np.float32(rho_b)), float(np.float32(1.0 - rho_b))
    return False, float(np.float32(-rho_b)), float(np.float32(1.0 + rho_b))


def scout_block_valid(nq: int, nk: int, block_q: int, block_k: int,
                      Sk: int, causal: bool, device=None) -> torch.Tensor:
    """[nq, nk] analytic block validity of the scout: block start < Sk
    and, under causal, <= the q tile's last row."""
    blk = torch.arange(nk, device=device)
    bvalid = (blk * block_k < Sk)[None, :]
    if causal:
        last_row = torch.arange(nq, device=device) * block_q + block_q - 1
        bvalid = bvalid & (blk[None, :] * block_k <= last_row[:, None])
    return bvalid.expand(nq, nk)


def scout_row_threshold(theta, bvalid, rho_b: float) -> torch.Tensor:
    """The scout's row threshold Θ [..., nq] over valid blocks: the exact
    row sum of the fp32 thetas rounded once, over the valid count, then
    c_ext·(max or min) + c_mean·mean in fp32."""
    cnt = torch.clamp(bvalid.sum(-1).to(F32), min=1.0)
    use_max, c_ext, c_mean = scout_coefficients(rho_b)
    if use_max:
        ext = torch.where(bvalid, theta, -BIG).amax(-1)
    else:
        ext = torch.where(bvalid, theta, BIG).amin(-1)
    tmean = torch.where(bvalid, theta, 0.0).to(torch.float64).sum(-1) \
        .to(F32) / cnt
    return ext * c_ext + tmean * c_mean


def hdp_scout_plain(iq, ik, *, rho_b: float, block_q: int = 128,
                    block_k: int = 128, causal: bool = True,
                    chunk_blocks: int = 8):
    """The scout kernel's arithmetic (``hdp_scout.py`` Pallas body).

    For each q tile and each chunk of ``chunk_blocks`` KV blocks: |IQ·IKᵀ|
    masked to rows < Sq, cols < Sk (and rows >= cols under causal),
    pooled per block. The sums are exact (float64 over integer values)
    and round to fp32 once. The Sparsity Engine then takes the analytic
    block validity (block start < Sk, and under causal <= the tile's
    last row), the row threshold over valid blocks (mean = exact sum
    rounded once, divided by the valid count) and keep = theta >= Θ ∧
    valid. theta_head is the exact sum of a head's thetas, rounded once.
    Returns (theta [B,H,nq,nk] f32, keep bool, theta_head [B,H] f32)."""
    B, H, Sq, hd = iq.shape
    Sk = ik.shape[2]
    nq, nk = _ceil_div(Sq, block_q), _ceil_div(Sk, block_k)
    ck = max(1, min(chunk_blocks, nk))
    nkc = _ceil_div(nk, ck)
    dev = iq.device
    iqp = _pad_seq(iq.to(torch.float64), nq * block_q)
    ikp = _pad_seq(ik.to(torch.float64), nkc * ck * block_k)
    theta64 = torch.zeros(B, H, nq, nkc * ck, dtype=torch.float64,
                          device=dev)
    for i in range(nq):
        rows = i * block_q + torch.arange(block_q, device=dev)
        for j in range(nkc):
            cols = j * ck * block_k + torch.arange(ck * block_k, device=dev)
            s = torch.einsum("bhqd,bhkd->bhqk", iqp[:, :, rows],
                             ikp[:, :, cols])
            valid = (cols[None, :] < Sk) & (rows[:, None] < Sq)
            if causal:
                valid = valid & (rows[:, None] >= cols[None, :])
            s = torch.where(valid, s.abs(), 0.0)
            theta64[:, :, i, j * ck:(j + 1) * ck] = s.reshape(
                B, H, block_q, ck, block_k).sum(dim=(2, 4))
    bvalid = scout_block_valid(nq, nkc * ck, block_q, block_k, Sk, causal,
                               device=dev)
    theta64 = torch.where(bvalid, theta64, 0.0)
    theta = theta64.to(F32)
    keep = (theta >= scout_row_threshold(theta, bvalid, rho_b)[..., None]) \
        & bvalid
    theta_head = theta64.sum((-2, -1)).to(F32)
    return theta[..., :nk], keep[..., :nk], theta_head


def hdp_block_sparse_attention_plain(q, k, v, kv_idx, counts, head_kept, *,
                                     causal: bool = True,
                                     approx: bool = True,
                                     block_q: int = 128, block_k: int = 128,
                                     score_scale=None,
                                     kv_len=None) -> torch.Tensor:
    """The block kernel's arithmetic (``hdp_block_attn.py`` Pallas body).

    For each (b·h, q tile) it walks the listed KV blocks ``kv_idx[..., j]``
    for j < ``counts`` (none for a head with ``head_kept`` = 0): scores
    QKᵀ − FQ·FKᵀ (fractions by trunc) times fp32(1/√hd)·score_scale,
    masked to cols < kv_len (and rows >= cols under causal), an online
    softmax whose P·V product rounds p to V's dtype. Empty rows and
    gated heads output 0. Returns [B,H,Sq,hd] in q's dtype."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    nq, nk = _ceil_div(Sq, block_q), _ceil_div(Sk, block_k)
    BH, mk = B * H, kv_idx.shape[-1]
    dev = q.device
    qf = _pad_seq(q.to(F32), nq * block_q).reshape(BH, nq, block_q, hd)
    kb = _pad_seq(k.to(F32), nk * block_k).reshape(BH, nk, block_k, hd)
    vb = _pad_seq(v, nk * block_k).reshape(BH, nk, block_k, hd)
    fq = qf - torch.trunc(qf)
    idx = kv_idx.reshape(BH, nq, mk).long()
    cnt = counts.reshape(BH, nq)
    hk = head_kept.reshape(BH) > 0
    lens = torch.full((BH,), Sk, device=dev) if kv_len is None \
        else torch.clamp(kv_len.reshape(BH), max=Sk)
    sc = f32_scalar(float(np.float32(1.0 / (hd ** 0.5))), dev)
    if score_scale is not None:
        sc = sc * f32_scalar(score_scale, dev)
    rows = (torch.arange(nq, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))                 # [nq,bq]
    m = torch.full((BH, nq, block_q), NEG, dtype=F32, device=dev)
    l = torch.zeros((BH, nq, block_q), dtype=F32, device=dev)
    acc = torch.zeros((BH, nq, block_q, hd), dtype=F32, device=dev)
    bh = torch.arange(BH, device=dev)[:, None]
    for j in range(mk):
        active = (j < cnt) & hk[:, None]                          # [BH,nq]
        blk = idx[:, :, j]
        kt, vt = kb[bh, blk], vb[bh, blk]                     # [BH,nq,bk,hd]
        s = torch.einsum("xiqd,xikd->xiqk", qf, kt)
        if approx:
            s = s - torch.einsum("xiqd,xikd->xiqk", fq,
                                 kt - torch.trunc(kt))
        s = s * sc
        cols = blk[..., None] * block_k + torch.arange(block_k, device=dev)
        valid = cols[:, :, None, :] < lens[:, None, None, None]
        if causal:
            valid = valid & (rows[None, :, :, None] >= cols[:, :, None, :])
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        pv = torch.einsum("xiqk,xikd->xiqd", p.to(v.dtype).to(F32),
                          vt.to(F32))
        a = active[..., None]
        l = torch.where(a, l * corr + p.sum(-1), l)
        m = torch.where(a, m_new, m)
        acc = torch.where(a[..., None], acc * corr[..., None] + pv, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out * hk[:, None, None, None].to(F32)
    return out.reshape(B, H, nq * block_q, hd)[:, :, :Sq].to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """The flash kernel's arithmetic (``flash_attention.py`` Pallas body):
    an online softmax over KV tiles, scores q·k times fp32(1/√hd) masked
    to cols < Sk (and rows >= cols under causal), tiles wholly in the
    future of a q tile skipped, p rounded to V's dtype for P·V. Returns
    [B,H,Sq,hd] in q's dtype."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    nq, nk = _ceil_div(Sq, block_q), _ceil_div(Sk, block_k)
    BH = B * H
    dev = q.device
    qf = _pad_seq(q.to(F32), nq * block_q).reshape(BH, nq, block_q, hd)
    kb = _pad_seq(k.to(F32), nk * block_k).reshape(BH, nk, block_k, hd)
    vb = _pad_seq(v, nk * block_k).reshape(BH, nk, block_k, hd)
    scale = float(np.float32(1.0 / (hd ** 0.5)))
    rows = (torch.arange(nq, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))                 # [nq,bq]
    m = torch.full((BH, nq, block_q), NEG, dtype=F32, device=dev)
    l = torch.zeros((BH, nq, block_q), dtype=F32, device=dev)
    acc = torch.zeros((BH, nq, block_q, hd), dtype=F32, device=dev)
    for j in range(nk):
        run = torch.ones(nq, dtype=torch.bool, device=dev) if not causal \
            else j * block_k <= rows[:, -1]                         # [nq]
        s = torch.einsum("xiqd,xkd->xiqk", qf, kb[:, j]) * scale
        cols = j * block_k + torch.arange(block_k, device=dev)
        valid = (cols < Sk)[None, None, :].expand(nq, block_q, block_k)
        if causal:
            valid = valid & (rows[:, :, None] >= cols[None, None, :])
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        pv = torch.einsum("xiqk,xkd->xiqd", p.to(v.dtype).to(F32),
                          vb[:, j].to(F32))
        r = run[None, :, None]
        l = torch.where(r, l * corr + p.sum(-1), l)
        m = torch.where(r, m_new, m)
        acc = torch.where(r[..., None], acc * corr[..., None] + pv, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, nq * block_q, hd)[:, :, :Sq].to(q.dtype)
