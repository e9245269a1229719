"""Multi-head GQA attention with HDP.

PyTorch counterpart of ``repro.models.attention``. ``attn_apply``
projects, applies qk-norm and rope, describes the call with
``build_attn_call`` and dispatches it through the
``repro_torch.attention`` registry. The paths
behind the registry's backends:

* ``chunked_attention`` — exact attention as an online softmax over KV
  chunks (``xla_dense`` prefill, the HDP-off path without a kernel);
  ``local_attention`` the sliding window's block-local form, and
  ``decode_attention`` exact decode against a whole cache;
* ``hdp_prefill_attention`` — the two-pass blockwise HDP (integer scout,
  then approximate attention on surviving blocks), used for prefill into
  a dense request cache (``xla_hdp``). A quantized-pool engine on the
  static grid first snaps K/V to the pool format, so prefill and the
  decode see the same values; ``hdp_decode_attention`` is HDP decode
  over the dense slot cache;
* ``hdp_paged_decode_attention`` — decode over the block-paged pool
  (int8, int8 K + fp8 V, or unquantized pages with an int8 scout copy of
  K): stage 1 streams the integer scout view of every allocated page,
  stage 2 keeps the pages some head still needs (Fetch-Upon-Mask), and
  stage 3 runs on those pages only: in plain PyTorch over page chunks
  (``paged_hdp_decode``), in the gather-free paged FUM kernel
  (``pallas_paged_decode``) or in the block-sparse kernel on a densified
  gather (``pallas_hdp_block``). A multi-query verify call (Sq > 1, the
  speculative round's) scouts each query row for itself; a draft call
  scores from the int8 scout copies alone and never reads the K pool.

Aligned self-attention prefill (no cache) resolves to the full-sequence
kernels through ``kernels.ops``: ``hdp_attention_tpu`` (scout + block
kernel) with HDP on, ``flash`` with HDP off.

Tensor conventions: activations x [B, S, D]; q [B, N, G, Sq, hd] where
N = kv heads and G = query group size; k/v [B, Sk, N, hd]. The internals
run in fp32 whatever the model dtype, as in the reference, and the
output is cast back to q's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.attention import AttnCall, AttnSpec, attention
from repro_torch.core import blocking
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import calibrated_split, decode_scout
from repro_torch.core.quant import (FRAC_SCOUT_SCALE, POISON_CODE,
                                    encode_pool, encode_pool_scaled,
                                    pool_int_bits, pool_scale,
                                    pool_view_finite, quantize_and_split,
                                    quantize_fixed, roundtrip_pool,
                                    scout_frac_codes, scout_int_codes,
                                    to_fp8_e4m3)
from repro_torch.distribution.tp import (active_serving_mesh, local_heads,
                                         tp_paged_attention)
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.kernels.ref import keep_mask_to_indices
from repro_torch.models import layers as L

_NEG = -1e30
F32 = torch.float32


# ------------------------------------------------------------------ params
def attn_init(cfg, gen: torch.Generator, dtype, device) -> Dict:
    d, h, n, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = L.torch_dtype(dtype)
    p = {
        "wq": L.dense_init(gen, (d, h, hd), dt, device),
        "wk": L.dense_init(gen, (d, n, hd), dt, device),
        "wv": L.dense_init(gen, (d, n, hd), dt, device),
        "wo": L.dense_init(gen, (h, hd, d), dt, device, in_axis=-3),
    }
    if cfg.qkv_bias:
        p.update(bq=torch.zeros(h, hd, dtype=dt, device=device),
                 bk=torch.zeros(n, hd, dtype=dt, device=device),
                 bv=torch.zeros(n, hd, dtype=dt, device=device))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(hd, dtype=dt, device=device),
                 k_norm=torch.ones(hd, dtype=dt, device=device))
    return p


def param_specs(cfg) -> Dict:
    """Logical axes of ``attn_init``'s leaves (the reference's spec half)."""
    s = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        s.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return s


# -------------------------------------------------------------- core maths
def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_axis(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """[..., Sq, Sk] bool validity from positions (-1 = invalid)."""
    valid = (k_pos[..., None, :] >= 0) & (q_pos[..., :, None] >= 0)
    if causal:
        valid = valid & (q_pos[..., :, None] >= k_pos[..., None, :])
    if window:
        valid = valid & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    return valid


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation and result (the reference's
    ``preferred_element_type=F32``): low-precision operands are widened
    first, which is exact."""
    return torch.einsum(eq, a.float(), b.float())


def chunked_attention(q, k, v, *, q_pos, k_pos, chunk: int,
                      causal: bool = True, window: int = 0):
    """Exact attention as an online softmax over KV chunks (a Python loop
    takes the place of the reference's ``lax.scan``).
    q [B,N,G,Sq,hd]; k,v [B,Sk,N,hd]; returns q's dtype."""
    B, N, G, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    nc = max(1, -(-Sk // chunk))
    Skp = nc * chunk
    k = _pad_axis(k, 1, Skp)
    v = _pad_axis(v, 1, Skp)
    k_pos = _pad_axis(k_pos + 1, 0, Skp) - 1     # pads become -1 (invalid)
    m = torch.full((B, N, G, Sq), _NEG, dtype=F32, device=q.device)
    l = torch.zeros((B, N, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, N, G, Sq, hd), dtype=F32, device=q.device)
    for c in range(nc):
        cols = slice(c * chunk, (c + 1) * chunk)
        s = _einsum_f32("bngqh,bcnh->bngqc", q, k[:, cols]) * scale
        valid = _mask_bias(q_pos, k_pos[cols], causal, window)
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = _einsum_f32("bngqc,bcnh->bngqh", p.to(v.dtype), v[:, cols])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def local_attention(q, k, v, *, q_pos, k_pos, window: int,
                    causal: bool = True):
    """Block-local sliding window: each q block of ``window`` rows attends
    to its own KV block and the previous one (cost O(S * 2w * hd)).
    Aligned self-attention only (q and k of one length)."""
    B, N, G, Sq, hd = q.shape
    Sk = k.shape[1]
    c = window
    Sqp, Skp = _ceil_to(Sq, c), _ceil_to(Sk, c)
    if Sqp != Skp:
        raise ValueError("local attention expects aligned q/k (self-attn)")
    nb = Sqp // c
    qb = _pad_axis(q, 3, Sqp).reshape(B, N, G, nb, c, hd)
    kb = _pad_axis(k, 1, Skp).reshape(B, nb, c, N, hd)
    vb = _pad_axis(v, 1, Skp).reshape(B, nb, c, N, hd)
    qp = _pad_axis(q_pos + 1, 0, Sqp).reshape(nb, c) - 1
    kp = _pad_axis(k_pos + 1, 0, Skp).reshape(nb, c) - 1

    def pair(x):   # the previous block beside each block: [B, nb, 2c, N, hd]
        prev = torch.roll(x, 1, dims=1)
        prev[:, 0] = 0
        return torch.cat([prev, x], dim=2)

    k2, v2 = pair(kb), pair(vb)
    kp_prev = torch.roll(kp, 1, dims=0)
    kp_prev[0] = -1
    kp2 = torch.cat([kp_prev, kp], dim=1)
    scale = 1.0 / (hd ** 0.5)
    s = _einsum_f32("bngtqh,btcnh->bngtqc", qb, k2) * scale
    valid = _mask_bias(qp, kp2, causal, window)      # [nb, c, 2c]
    s = torch.where(valid, s, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    den = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = _einsum_f32("bngtqc,btcnh->bngtqh", (p / den).to(v.dtype), v2)
    return out.reshape(B, N, G, Sqp, hd)[:, :, :, :Sq].to(q.dtype)


def decode_attention(q, k, v, *, q_pos, k_pos, window: int = 0,
                     causal: bool = True):
    """Exact attention of a few query tokens against a whole cache.
    q [B,N,G,Sq,hd], k/v [B,Sk,N,hd]; returns q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _einsum_f32("bngqh,bsnh->bngqs", q, k) * scale
    valid = _mask_bias(q_pos, k_pos, causal, window)
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    out = _einsum_f32("bngqs,bsnh->bngqh", p.to(v.dtype), v)
    return out.to(q.dtype)


# ----------------------------------------------------------------- HDP path
def hdp_prefill_attention(q, k, v, *, q_pos, k_pos, hdp: HDPConfig,
                          window: int = 0, return_stats: bool = False):
    """Two-pass blockwise HDP (Alg. 2 on block_q x block_k tiles).

    Pass A: integer scout per q-block -> theta, row threshold, keep
    mask, head importance. Pass B: approximate attention (QK^T - FQ FK^T)
    on surviving blocks, with the exact softmax or, with
    ``hdp.approx_softmax``, the HDP softmax unit's polynomial one. Python
    loops over q-blocks take the place of the reference's ``lax.scan``."""
    B, N, G, Sq, hd = q.shape
    Sk = k.shape[1]
    bq, bk = hdp.block_q, hdp.block_k
    Sqp, Skp = _ceil_to(Sq, bq), _ceil_to(Sk, bk)
    nq = Sqp // bq
    scale = 1.0 / (hd ** 0.5)

    sq, qq, iq, fq = calibrated_split(_pad_axis(q, 3, Sqp).float(), hdp)
    sk, kq, ik, fk = calibrated_split(_pad_axis(k, 1, Skp).float(), hdp)
    score_scale = scale * torch.reciprocal(sq * sk)
    vp = _pad_axis(v, 1, Skp)
    qp = _pad_axis(q_pos + 1, 0, Sqp) - 1
    kp = _pad_axis(k_pos + 1, 0, Skp) - 1

    # ---- pass A: integer scout -> keep mask, head importance ----
    theta_head = torch.zeros((B, N, G), dtype=F32, device=q.device)
    n_valid = torch.zeros((), dtype=F32, device=q.device)
    n_blocks = torch.zeros((), dtype=F32, device=q.device)
    keep_rows = []
    for i in range(nq):
        rows = slice(i * bq, (i + 1) * bq)
        s_int = _einsum_f32("bngqh,bsnh->bngqs", iq[:, :, :, rows], ik)
        valid = _mask_bias(qp[rows], kp, hdp.causal, window)
        theta, bvalid = blocking.pooled_block_theta(s_int, valid, bk)
        if hdp.block_pruning:
            thr = blocking.row_threshold(theta, hdp.rho_b, bvalid)
            keep = blocking.block_keep_mask(theta, thr, bvalid)
        else:
            keep = bvalid.expand(theta.shape)
        theta_head = theta_head + torch.where(bvalid, theta, 0.0).sum(-1)
        n_valid = n_valid + valid.sum().to(F32)
        n_blocks = n_blocks + bvalid.sum().to(F32)
        keep_rows.append(keep)
    if hdp.normalize_head_score:
        theta_head = theta_head / torch.clamp(n_valid, min=1.0)
    head_kept = (theta_head > hdp.tau_h) if hdp.head_pruning \
        else torch.ones_like(theta_head, dtype=torch.bool)

    # ---- pass B: approximate attention on surviving blocks ----
    outs = []
    for i in range(nq):
        rows = slice(i * bq, (i + 1) * bq)
        s = _einsum_f32("bngqh,bsnh->bngqs", qq[:, :, :, rows], kq)
        if hdp.approx:
            s = s - _einsum_f32("bngqh,bsnh->bngqs", fq[:, :, :, rows], fk)
        s = s * score_scale
        valid = _mask_bias(qp[rows], kp, hdp.causal, window)
        keep_e = keep_rows[i].repeat_interleave(bk, dim=-1)[..., None, :] \
            & valid
        s = torch.where(keep_e, s, _NEG)
        if hdp.approx_softmax:
            p = blocking.approx_softmax(s, keep_e)
        else:
            p = torch.exp(s - s.amax(-1, keepdim=True))
            p = torch.where(keep_e, p, 0.0)
            p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        outs.append(_einsum_f32("bngqs,bsnh->bngqh", p.to(vp.dtype), vp))
    out = torch.cat(outs, dim=3)[:, :, :, :Sq]
    out = out * head_kept[..., None, None].to(out.dtype)

    stats = None
    if return_stats:
        # constant divisors as products with the reciprocal, as XLA
        # compiles the reference's means
        kept = torch.stack(keep_rows).to(F32).sum() * (1.0 / (B * N * G))
        stats = {
            "block_sparsity": 1.0 - kept / torch.clamp(n_blocks, min=1.0),
            "head_sparsity": 1.0 - head_kept.to(F32).sum()
            * (1.0 / head_kept.numel()),
            "theta_head": theta_head,
        }
    return out.to(q.dtype), stats


def _expand_keep(keep, block_k, valid, ndim):
    """[..., nk] or [..., Sq, nk] block keep -> element mask of ``ndim``
    dims (pooled masks broadcast over the query axis)."""
    keep_e = keep.repeat_interleave(block_k, dim=-1)
    if keep_e.dim() < ndim:
        keep_e = keep_e[..., None, :]
    return keep_e & valid


def _head_gate(out, head_kept):
    """Early head gate: [...] gates broadcast against [..., Sq, hd]."""
    gate = head_kept
    while gate.dim() < out.dim():
        gate = gate[..., None]
    return out * gate.to(out.dtype)


def _block_sparsity_stats(keep, bvalid, head_kept):
    """Per-slot pruned fractions over *valid* blocks ([B] leaves, so the
    engine can mask parked slots out of its means)."""
    ax = tuple(range(1, keep.dim()))
    kept = (keep & bvalid).to(F32).sum(ax)
    tot = torch.clamp(bvalid.expand(keep.shape).to(F32).sum(ax), min=1.0)
    hax = tuple(range(1, head_kept.dim()))
    n_heads = 1
    for a in hax:
        n_heads *= head_kept.shape[a]
    return {"block_sparsity": 1.0 - kept / tot,
            "head_sparsity": 1.0 - head_kept.to(F32).sum(hax) * (1.0 / n_heads)}


def _approx_block_attention(qq, fq, kq, fk, v, keep, valid, head_kept, *,
                            block_k, scale, approx, scores=None):
    """The shared decode stage: FUM scores (QK^T - FQ FK^T) on the blocks
    ``keep`` leaves, masked softmax, early head gate. ``scale`` folds
    1/sqrt(hd) and any calibration rescale; ``block_k`` is the width the
    [..., nk] keep mask expands by to the score columns. ``scores``
    (before the scale) replaces QK^T - FQ FK^T: the speculative draft
    hands in its scout-copy scores."""
    if scores is None:
        s = _einsum_f32("bngqh,bsnh->bngqs", qq, kq)
        if approx:
            s = s - _einsum_f32("bngqh,bsnh->bngqs", fq, fk)
    else:
        s = scores
    s = s * scale
    keep_e = _expand_keep(keep, block_k, valid, s.dim())
    s = torch.where(keep_e, s, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(keep_e, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = _einsum_f32("bngqs,bsnh->bngqh", p.to(v.dtype), v)
    return _head_gate(out, head_kept)


def _draft_scores(s_int, iq, ik, fq, fkh, draft):
    """Draft score source from the scout copies: s_int alone ("int"), or
    QQ.IK + IQ.FK^ = s_int + FQ.IK + IQ.FK^ ("scout"), where FK^ is K's
    fraction on the 2^-6 grid of the fraction copy."""
    if draft.scores == "int":
        return s_int
    return s_int + _einsum_f32("bngqh,bsnh->bngqs", fq, ik) \
        + _einsum_f32("bngqh,bsnh->bngqs", iq, fkh)


def hdp_decode_attention(q, k, v, *, q_pos, k_pos, hdp: HDPConfig,
                         window: int = 0, return_stats: bool = False,
                         draft=None, per_query: bool = False):
    """HDP decode over a dense cache: the integer scout prunes KV blocks
    of ``block_k`` positions (and heads), and the FUM attention runs on
    the surviving blocks. q [B,N,G,Sq,hd], k/v [B,Sk,N,hd], calibrated
    by ``hdp.calib`` over the call's q and the whole cache.
    ``per_query`` scouts each query row for itself (the verify shape);
    ``draft`` (a DraftProfile, its thresholds already in ``hdp``) scores
    from the scout copies, recomputed here from the cache's K with the
    paged pool's fraction grid, so the scores equal the paged draft's.
    The softmax is the exact one whatever ``hdp.approx_softmax`` says:
    the reference's decode never reads that flag."""
    hd = q.shape[-1]
    Sk = k.shape[1]
    bk = hdp.block_k
    Skp = _ceil_to(Sk, bk)
    scale = 1.0 / (hd ** 0.5)
    sq, qq, iq, fq = calibrated_split(q.float(), hdp)
    sk, kq, ik, fk = calibrated_split(_pad_axis(k, 1, Skp).float(), hdp)
    vp = _pad_axis(v, 1, Skp)
    kp = _pad_axis(k_pos + 1, k_pos.dim() - 1, Skp) - 1
    s_int = _einsum_f32("bngqh,bsnh->bngqs", iq, ik)
    valid = _mask_bias(q_pos, kp, hdp.causal, window)
    keep, bvalid, _, theta_head, head_kept = decode_scout(
        s_int, valid, hdp, per_query=per_query)
    scores = None
    if draft is not None and draft.scores != "approx":
        fkh = torch.round(fk * FRAC_SCOUT_SCALE) / FRAC_SCOUT_SCALE
        scores = _draft_scores(s_int, iq, ik, fq, fkh, draft)
    out = _approx_block_attention(
        qq, fq, kq, fk, vp, keep, valid, head_kept, block_k=bk,
        scale=scale * torch.reciprocal(sq * sk), approx=hdp.approx,
        scores=scores)
    stats = None
    if return_stats:
        stats = {**_block_sparsity_stats(keep, bvalid, head_kept),
                 "theta_head": theta_head}
    return out.to(q.dtype), stats


def _fixed_split(x, hdp: HDPConfig):
    """Calibration-free fixed-point split (xq, I, F) on the static grid
    the write-time pool quantization assumes."""
    return quantize_and_split(x.float(), hdp.int_bits, hdp.frac_bits)


def resolve_write_pages(positions, page_table, page_size, write_floor=None):
    """[B, S] write positions -> [B, S] destination pool page per write.

    Columns past the table width and columns below the slot's
    ``write_floor`` (shared read-only prefix pages) redirect to the
    scratch page 0; unallocated columns are already 0 in the table."""
    nP = page_table.shape[1]
    pcol = torch.div(positions, page_size, rounding_mode="floor")
    pidx = torch.gather(page_table, 1,
                        torch.clamp(pcol, max=nP - 1).long())
    pidx = torch.where(pcol < nP, pidx, 0)
    if write_floor is not None:
        pidx = torch.where(pcol >= write_floor[:, None], pidx, 0)
    return pidx


def scout_int8(k, hdp: HDPConfig):
    """Write-time int8 scout copy of K that an unquantized pool stores:
    the same codes a quantized pool derives as its stage-1 view."""
    return scout_int_codes(k, hdp.int_bits, hdp.frac_bits)


def scout_frac_int8(k, hdp: HDPConfig):
    """Write-time int8 quantized-fraction copy of K (``f_scout``), which a
    speculating unquantized pool stores so that the draft scores from
    the two int8 copies without reading the K pool (a quantized pool
    derives the fraction from its codes)."""
    return scout_frac_codes(k, hdp.int_bits, hdp.frac_bits)


def _dequant_pages(pages, scale):
    """Gathered pool pages [..., ps, N, hd] + per-page scales [..., N]
    -> fp32 values. int8 codes: the poison code -128 decodes to NaN; fp8
    V: the exponent does the scale's job (its scale stays 1.0). A NaN
    scale poisons the page either way."""
    if pages.dtype == torch.int8:
        vals = torch.where(pages == POISON_CODE,
                           torch.full(pages.shape, float("nan"), dtype=F32,
                                      device=pages.device), pages.to(F32))
    else:
        vals = pages.to(F32)
    return vals * scale[..., None, :, None].to(F32)


def _gather_pages(k_pool, v_pool, idx, k_scale, v_scale):
    """Pool pages at ``idx`` [B, n] -> K and V [B, n, ps, N, hd]: fp32
    values of a quantized pool, the pool's own dtype otherwise."""
    if k_pool.dtype == torch.int8:
        return (_dequant_pages(k_pool[idx], k_scale[idx]),
                _dequant_pages(v_pool[idx], v_scale[idx]))
    return k_pool[idx], v_pool[idx]


def _paged_scout(q, k_pool, table, *, q_pos, k_pos, hdp: HDPConfig,
                 window: int = 0, ik_pool=None, k_scale=None,
                 kv_scale: str = "grid", per_query: bool = False):
    """Stages 1 and 2 of the paged decode.

    Stage 1 reads the integer scout stream of every allocated page: an
    int8 pool's finite static-grid view of its codes (poison -> 0), or,
    under ``kv_scale="absmax"``, the codes times a sanitized copy of the
    page scales (NaN freed-page poison -> the static step); an
    unquantized pool's write-time ``ik_pool`` copy. Then the decode
    scout (per query row with ``per_query``); stage 2 ORs ``keep &
    head_kept`` over heads (and query rows: a verify call reads the pool
    once for all of them) into the per-row page fetch list. Returns
    (qq, iq, fq, ik, k_fin, s_int, keep, bvalid, theta, theta_head,
    head_kept, fetched); ``k_fin`` is a quantized pool's finite K view
    (None for an unquantized pool), from which a draft takes K's
    fraction."""
    B = q.shape[0]
    nP = table.shape[1]
    ps, N, hd = k_pool.shape[1:]
    tbl = table.long()
    k_fin = None
    if k_pool.dtype != torch.int8:
        if ik_pool is None:
            raise ValueError("an unquantized pool needs its int8 scout copy "
                             "(ik_pool)")
        ik = ik_pool[tbl].reshape(B, nP * ps, N, hd).to(F32)
    elif kv_scale == "absmax":
        codes = k_pool[tbl]                              # [B,nP,ps,N,hd]
        ksc = k_scale[tbl]                               # [B,nP,N]
        ksc = torch.where(torch.isfinite(ksc), ksc,
                          torch.full_like(ksc, pool_scale(hdp.int_bits)))
        cf = torch.where(codes == POISON_CODE, torch.zeros_like(codes),
                         codes).to(F32)
        k_fin = (cf * ksc[:, :, None, :, None]).reshape(B, nP * ps, N, hd)
        ik = torch.trunc(k_fin)
    else:
        k_fin = pool_view_finite(k_pool[tbl], hdp.int_bits).reshape(
            B, nP * ps, N, hd)
        ik = torch.trunc(k_fin)
    qq, iq, fq = _fixed_split(q, hdp)
    s_int = _einsum_f32("bngqh,bsnh->bngqs", iq, ik)
    valid = _mask_bias(q_pos, k_pos, hdp.causal, window)
    keep, bvalid, theta, theta_head, head_kept = decode_scout(
        s_int, valid, hdp, per_query=per_query)
    # a page holds every kv head: fetch it if any head (or query row)
    # still needs it; early-gated heads (output zeroed) demand nothing
    fetched = (keep & head_kept[..., None]).flatten(1, -2).any(1)  # [B, nP]
    return (qq, iq, fq, ik, k_fin, s_int, keep, bvalid, theta, theta_head,
            head_kept, fetched)


def _fetch_list(fetched, table, keep, q_pos):
    """Compress the fetch mask into the kernel's page lists.

    Kept pages in ascending logical order, padded with the scratch page
    0 past each row's count: (page_ids [B,nP], logical [B,nP], counts
    [B], keep_in [B,nP,N,G,Sq] int32, kv_len [B]). A pooled keep
    [B,N,G,nP] holds for every query row, a per-row one is
    [B,N,G,Sq,nP]."""
    B, nP = fetched.shape
    N, G = keep.shape[1:3]
    Sq = q_pos.shape[-1]
    ar = torch.arange(nP, dtype=torch.int32, device=fetched.device)
    key = torch.where(fetched, ar[None], torch.iinfo(torch.int32).max)
    logical = torch.sort(key, dim=-1).values
    counts = fetched.sum(-1).to(torch.int32)
    in_range = ar[None] < counts[:, None]
    logical = torch.where(in_range, logical, 0)
    page_ids = torch.where(in_range, torch.gather(table, 1, logical.long()), 0)
    keep_q = (keep if keep.dim() == 5 else keep[..., None, :]).expand(
        B, N, G, Sq, nP)
    idx = logical.long()[:, None, None, None, :].expand(B, N, G, Sq, nP)
    keep_in = torch.gather(keep_q, -1, idx).permute(0, 4, 1, 2, 3)
    # row 0's extent; the kernel adds the query index (consecutive rows)
    kv_len = q_pos.reshape(B, Sq)[:, 0] + 1
    return (page_ids.to(torch.int32).contiguous(),
            logical.to(torch.int32).contiguous(), counts.contiguous(),
            keep_in.to(torch.int32).contiguous(),
            kv_len.to(torch.int32).contiguous())


def _paged_fum_kernel_stage3(qq, k_pool, v_pool, table, keep, head_kept,
                             q_pos, fetched, *, hdp: HDPConfig,
                             k_scale, v_scale):
    """Stage 3 through the gather-free FUM kernel: only pages in the
    fetch list are ever read from the pool."""
    page_ids, logical, counts, keep_in, kv_len = _fetch_list(
        fetched, table, keep, q_pos)
    out = hdp_paged_fum_decode(
        qq.contiguous(), k_pool, v_pool, page_ids, logical, counts, keep_in,
        kv_len, approx=hdp.approx, int_bits=hdp.int_bits,
        frac_bits=hdp.frac_bits, k_scale=k_scale, v_scale=v_scale)
    return _head_gate(out, head_kept)


def _paged_block_kernel_stage3(qq, k_pool, v_pool, table, keep, theta,
                               head_kept, q_pos, fetched, *, hdp: HDPConfig,
                               k_scale, v_scale):
    """Stage 3 through the block-sparse kernel on a densified gather.

    Surviving pages are gathered into contiguous [B,H,nP*ps,hd] K
    (snapped to the fixed-point grid) and V (dequantized to fp32 from a
    quantized pool, in the pool's dtype otherwise); pruned pages' gather
    indices point at the scratch page. The page keep mask and its
    importances become per-head block lists, and every query row's valid
    extent is its own position + 1 (the aligned prefill's causal mask is
    wrong for a cached decode)."""
    B, N, G, Sq, hd = qq.shape
    nP = table.shape[1]
    ps = k_pool.shape[1]
    H = N * G
    gather = torch.where(fetched, table, 0).long()            # pruned -> 0
    k, v = _gather_pages(k_pool, v_pool, gather, k_scale, v_scale)

    def per_head(x):   # [B,nP,ps,N,hd] -> [B,H,nP*ps,hd]
        x = x.reshape(B, nP * ps, N, hd).transpose(1, 2)
        return x.repeat_interleave(G, dim=1).contiguous()

    kq = per_head(quantize_fixed(k.to(F32), hdp.int_bits, hdp.frac_bits))
    kv_idx, counts = keep_mask_to_indices(
        keep.reshape(B, H, 1, nP), theta.reshape(B, H, 1, nP), nP)
    lens = (q_pos.reshape(B, Sq)[:, :1] + 1).expand(B, H).to(torch.int32)
    out = hdp_block_sparse_attention(
        qq.reshape(B, H, Sq, hd).contiguous(), kq, per_head(v), kv_idx,
        counts, head_kept.reshape(B, H), causal=False, approx=hdp.approx,
        block_q=max(8, Sq), block_k=ps, score_scale=1.0, kv_len=lens)
    return out.reshape(B, N, G, Sq, hd)


def _paged_scan_attention(qq, fq, k_pool, v_pool, gather_idx, keep, valid,
                          head_kept, *, hdp: HDPConfig, ps: int, cpp: int,
                          scale: float, k_scale=None, v_scale=None):
    """Stages 2 and 3 as an online softmax over chunks of ``cpp`` pages
    (a Python loop takes the place of the reference's ``lax.scan``).

    Peak stage-2 memory is one chunk of gathered pages instead of the
    whole context; pruned pages' gather indices point at the scratch
    page, and a quantized pool is dequantized chunk by chunk. The sums
    group by page chunk, so the output differs from the one-slab softmax
    in the last bits only."""
    B, N, G, Sq, hd = qq.shape
    nP = gather_idx.shape[1]
    nc = -(-nP // cpp)
    pad = nc * cpp - nP
    idx_p = _pad_axis(gather_idx, 1, nc * cpp)                # pads -> 0
    keep_p = _pad_axis(keep, keep.dim() - 1, nc * cpp)
    valid_p = _pad_axis(valid.expand(B, 1, 1, Sq, nP * ps), 4,
                        (nP + pad) * ps)
    m = torch.full((B, N, G, Sq), _NEG, dtype=F32, device=qq.device)
    l = torch.zeros((B, N, G, Sq), dtype=F32, device=qq.device)
    acc = torch.zeros((B, N, G, Sq, hd), dtype=F32, device=qq.device)
    for c in range(nc):
        pages = slice(c * cpp, (c + 1) * cpp)
        k_i, v_i = _gather_pages(k_pool, v_pool, idx_p[:, pages], k_scale,
                                 v_scale)
        k_i = k_i.reshape(B, cpp * ps, N, hd)
        v_i = v_i.reshape(B, cpp * ps, N, hd)
        kq_i, _, fk_i = _fixed_split(k_i, hdp)
        s = _einsum_f32("bngqh,bsnh->bngqs", qq, kq_i)
        if hdp.approx:
            s = s - _einsum_f32("bngqh,bsnh->bngqs", fq, fk_i)
        s = s * scale
        keep_e = _expand_keep(keep_p[..., pages], ps,
                              valid_p[..., c * cpp * ps:(c + 1) * cpp * ps],
                              s.dim())
        s = torch.where(keep_e, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(keep_e, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _einsum_f32(
            "bngqs,bsnh->bngqh", p.to(v_i.dtype), v_i)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _head_gate(out, head_kept)


#: stage-3 implementations of the paged decode
STAGE3 = ("xla", "pallas_paged", "pallas_block")


def hdp_paged_decode_attention(q, k_pool, v_pool, ik_pool, table, *, q_pos,
                               k_pos, hdp: HDPConfig, window: int = 0,
                               return_stats: bool = False,
                               stage3: str = "xla", page_chunk: int = 128,
                               draft=None, per_query: bool = False,
                               fk_pool=None, k_scale=None, v_scale=None,
                               kv_scale: str = "grid"):
    """HDP decode over the block-paged pool: the Fetch-Upon-Mask dataflow.

    q [B,N,G,Sq,hd]; k/v_pool [P,ps,N,hd] page pools (page 0 is the
    scratch page): int8 codes, or int8 K and fp8 V, with ``k_scale``/
    ``v_scale`` [P,N] fp32 per-page scales; or unquantized pages in the
    model's dtype with ``ik_pool``, their int8 scout copy of K. table
    [B,nP] int32 page table (0-padded); q_pos [B,1,1,Sq], k_pos
    [B,1,1,nP*ps].

    Stage 1 streams the integer scout view of every allocated page and
    derives the keep mask and head gate (``_paged_scout``); stage 2
    fetches only the pages some head still needs; stage 3 runs the FUM
    attention QK^T - FQ FK^T on them, chosen by ``stage3``:

    * ``"xla"`` — plain PyTorch: contexts up to ``page_chunk`` columns
      gather the kept pages into one slab (the dense layout's reduction
      order), longer ones run an online softmax over page chunks;
    * ``"pallas_paged"`` — the gather-free FUM kernel;
    * ``"pallas_block"`` — the block-sparse kernel on a densified gather
      (single-query decode).

    The kernels' per-row validity is an upper bound (cols < kv_len), so
    a sliding window falls back to "xla", as does "pallas_paged" under
    ``kv_scale="absmax"``: the kernel's scout view assumes the static
    grid; "pallas_block" falls back too for a per-query call.

    ``per_query`` scouts each of the Sq rows for itself (the multi-query
    verify: row j gets the keep mask and head gate of its own single
    step). ``draft`` (a DraftProfile, its thresholds already in ``hdp``)
    replaces stage 3 by the draft's: scores from the int8 scout copies
    (s_int, or s_int + FQ.IK + IQ.FK^ with the fraction copy ``fk_pool``
    of an unquantized pool, or K's fraction from a quantized pool's
    codes), V gathered for fetched pages only, and ``k_pool`` never read
    in stage 3. Returns (out [B,N,G,Sq,hd] in q's dtype, stats or
    None)."""
    if stage3 not in STAGE3:
        raise ValueError(f"stage3 must be one of {STAGE3}, got {stage3!r}")
    B, N, G, Sq, hd = q.shape
    ps = k_pool.shape[1]
    nP = table.shape[1]
    scale = 1.0 / (hd ** 0.5)
    quantized = k_pool.dtype == torch.int8
    absmax = quantized and kv_scale == "absmax"
    if stage3 == "pallas_block" and per_query:
        stage3 = "xla"
    if stage3 == "pallas_block" and Sq != 1:
        raise ValueError("the densifying block stage serves single-query "
                         "decode only")
    (qq, iq, fq, ik, k_fin, s_int, keep, bvalid, theta, theta_head,
     head_kept, fetched) = _paged_scout(
        q, k_pool, table, q_pos=q_pos, k_pos=k_pos, hdp=hdp, window=window,
        ik_pool=ik_pool, k_scale=k_scale, kv_scale=kv_scale,
        per_query=per_query)
    if stage3 != "xla" and window:
        stage3 = "xla"
    if stage3 == "pallas_paged" and absmax:
        stage3 = "xla"
    ks, vs = (k_scale, v_scale) if quantized else (None, None)
    if draft is not None and draft.scores != "approx":
        s = s_int
        if draft.scores == "scout":
            if quantized:
                fkh = k_fin - ik     # the codes' grid lies on the 2^-6 grid
            elif fk_pool is None:
                # the IQ.FK^ term needs the fraction copy: reading the K
                # pool instead would break the draft's promise
                raise ValueError(
                    'draft scores="scout" needs the f_scout pool '
                    "(PagedKVCache(draft_scout=True)); pass fk_pool or "
                    'use scores="int"')
            else:
                fkh = fk_pool[table.long()].reshape(B, nP * ps, N, hd).to(
                    F32) / FRAC_SCOUT_SCALE
            s = _draft_scores(s_int, iq, ik, fq, fkh, draft)
        valid = _mask_bias(q_pos, k_pos, hdp.causal, window)
        gather = torch.where(fetched, table, 0).long()      # pruned -> 0
        if quantized:
            v = _dequant_pages(v_pool[gather], v_scale[gather])
        else:
            v = v_pool[gather]
        out = _approx_block_attention(
            None, None, None, None, v.reshape(B, nP * ps, N, hd), keep,
            valid, head_kept, block_k=ps, scale=scale, approx=False,
            scores=s)
    elif stage3 == "pallas_paged":
        out = _paged_fum_kernel_stage3(qq, k_pool, v_pool, table, keep,
                                       head_kept, q_pos, fetched, hdp=hdp,
                                       k_scale=ks, v_scale=vs)
    elif stage3 == "pallas_block":
        out = _paged_block_kernel_stage3(qq, k_pool, v_pool, table, keep,
                                         theta, head_kept, q_pos, fetched,
                                         hdp=hdp, k_scale=ks, v_scale=vs)
    else:
        valid = _mask_bias(q_pos, k_pos, hdp.causal, window)
        gather = torch.where(fetched, table, 0).long()      # pruned -> 0
        cpp = max(1, page_chunk // ps)                      # pages a chunk
        if nP <= cpp:
            k, v = _gather_pages(k_pool, v_pool, gather, ks, vs)
            kq, _, fk = _fixed_split(k.reshape(B, nP * ps, N, hd), hdp)
            out = _approx_block_attention(
                qq, fq, kq, fk, v.reshape(B, nP * ps, N, hd), keep, valid,
                head_kept, block_k=ps, scale=scale, approx=hdp.approx)
        else:
            out = _paged_scan_attention(qq, fq, k_pool, v_pool, gather, keep,
                                        valid, head_kept, hdp=hdp, ps=ps,
                                        cpp=cpp, scale=scale, k_scale=ks,
                                        v_scale=vs)
    stats = None
    if return_stats:
        alloc = torch.clamp((table > 0).to(F32).sum(-1), min=1.0)   # [B]
        page_frac = (fetched & (table > 0)).to(F32).sum(-1) / alloc
        stats = {**_block_sparsity_stats(keep, bvalid, head_kept),
                 "page_sparsity": 1.0 - torch.clamp(page_frac, max=1.0),
                 "theta_head": theta_head}
    return out.to(q.dtype), stats


# --------------------------------------------------------------- full layer
def build_attn_call(cfg, *, mode: str, paged: bool = False,
                    per_slot: bool = False, self_aligned: bool = False,
                    cross: bool = False, causal: bool = True,
                    collect_stats: bool = False, draft=None,
                    verify: bool = False,
                    kv_scale: str = "grid") -> AttnCall:
    """The AttnCall ``attn_apply`` dispatches on. The serving engine uses
    the same function to report the resolved backend per phase, so the
    report cannot drift from the dispatch. ``mode`` "train" marks a
    trainable call (whisper's encoder runs so), which takes HDP only
    with ``hdp.apply_in_training``; ``cross`` a cross-attention call,
    never causal and never windowed. ``draft`` (a DraftProfile) marks a
    speculative draft step, its threshold overrides folded into the
    call's HDP config; ``verify`` a multi-query verify call."""
    hdp = cfg.hdp
    use_hdp = (hdp is not None and hdp.enabled
               and (mode != "train" or hdp.apply_in_training))
    eff_causal = causal and not cross
    hdp_eff = hdp.replace(causal=eff_causal) if use_hdp else None
    if draft is not None and hdp_eff is not None:
        hdp_eff = draft.overlay(hdp_eff)
    return AttnCall(
        mode="decode" if mode == "decode" else "prefill",
        layout="paged" if paged else "dense",
        causal=eff_causal,
        window=0 if cross else cfg.sliding_window,
        hdp=hdp_eff,
        per_slot=per_slot,
        self_aligned=self_aligned,
        trainable=mode == "train",
        chunk=cfg.attn_chunk,
        needs_stats=collect_stats,
        draft=draft if use_hdp else None,
        verify=verify and mode == "decode",
        kv_scale=kv_scale if paged else "grid",
    )


def _spec_pool(cfg, attn: Optional[AttnSpec]) -> Tuple[str, str]:
    """(kv_dtype, kv_scale) of the pool an ``attn`` spec serves from, as
    the paged decode reads it; no spec, or kv_dtype "auto", means the
    default int8 pool of a family with KV pages, and no pool ("fp32")
    for the others, whose caches hold the projections as they are (as
    the reference's with no spec). The prefill's dense-cache snap reads
    the spec itself."""
    if attn is None or attn.kv_dtype == "auto":
        pooled = cfg.family in ("dense", "moe", "vlm")
        return ("int8" if pooled else "fp32",
                "grid" if attn is None else attn.kv_scale)
    return attn.kv_dtype, attn.kv_scale


def _paged_write(cfg, cache, k, v, pidx, off, kv_scale: str,
                 draft=None) -> None:
    """Write the step's K/V [B,S,N,hd] into the pool at (page, offset),
    in place, in the pool's format. A calibrated (absmax) pool encodes
    against the destination page's current scale (set at insert; a fresh
    decode page keeps the static step), NaN freed-page poison sanitized
    to the static step; fp8 V pages take the cast (NaN past its range);
    an unquantized pool also writes its int8 scout copies of K. A draft
    step scoring from the scout copies skips an unquantized pool's K
    write: later draft steps read the copies, and the verify rewrites
    every staged position with the exact K before anything else reads
    it (a quantized pool's codes are the copies, so they are written)."""
    pidx, off = pidx.long(), off.long()
    ib = pool_int_bits(cfg.hdp)
    v_fp8 = cache["v_pages"].dtype == torch.float8_e4m3fn
    if cache["k_pages"].dtype == torch.int8 and kv_scale == "absmax":
        s0 = pool_scale(ib)

        def page_scale(name):
            sc = cache[name][pidx]                           # [B,S,N]
            return torch.where(torch.isfinite(sc), sc,
                               torch.full_like(sc, s0))[..., None]

        k_store = encode_pool_scaled(k, page_scale("k_scale"))
        v_store = to_fp8_e4m3(v) if v_fp8 else \
            encode_pool_scaled(v, page_scale("v_scale"))
    elif cache["k_pages"].dtype == torch.int8:
        k_store = encode_pool(k, ib)
        v_store = to_fp8_e4m3(v) if v_fp8 else encode_pool(v, ib)
    else:
        k_store = k.to(cache["k_pages"].dtype)
        v_store = v.to(cache["v_pages"].dtype)
    skip_k = (cache["k_pages"].dtype != torch.int8 and draft is not None
              and draft.scores != "approx" and cfg.hdp is not None
              and cfg.hdp.enabled)
    if not skip_k:
        cache["k_pages"][pidx, off] = k_store
    cache["v_pages"][pidx, off] = v_store
    if "k_scout" in cache:
        cache["k_scout"][pidx, off] = scout_int8(k, cfg.hdp)
    if "f_scout" in cache:
        cache["f_scout"][pidx, off] = scout_frac_int8(k, cfg.hdp)


def attn_apply(cfg, p, x, *, mode: str, positions, cache=None,
               enc_out=None, causal: bool = True,
               static_cache: bool = False,
               collect_stats: bool = False, page_table=None,
               write_floor=None, draft=None,
               attn: Optional[AttnSpec] = None) -> Tuple:
    """Full MHA layer: project (with qk-norm where the config has it),
    rope (a rope config's self-attention only), attend through the
    registry, output-project.

    mode "train": positions [S], no cache (whisper's encoder, with
    ``causal=False``). mode "prefill": positions [S]; without ``cache``
    this is aligned self-attention over the whole sequence (the
    full-sequence kernels' call); ``cache`` is this layer's dense request
    cache {"k","v"} [B,Smax,N,hd], written in place at positions[0]. A
    quantized-pool engine on the static grid (``attn.kv_dtype`` "int8"
    or "fp8_v", or no spec on a family with KV pages: the default int8
    pool) first snaps K to the pool grid and V to the grid or through
    fp8, so prefill attention and the pool insert see one set of values;
    absmax pools, the unquantized pool and cross-attention skip it.
    ``enc_out`` [B,Se,D] makes it cross-attention: K/V are projected from
    it (and written at 0 of ``cache``, the cross cache, at prefill).
    mode "decode": positions [B,S] per slot; ``cache`` is this layer's
    paged pool {"k_pages","v_pages", "k_scale","v_scale" | "k_scout"}
    or its dense slot cache {"k","v"} [B,Smax,N,hd], written in place
    (the K/V scatter) before attention reads it; ``static_cache`` attends
    to ``cache`` as it is without writing (whisper's cross-attention at
    decode). ``write_floor`` [B] (page columns) fences shared prefix
    pages: writes below it land in the scratch page. Decode with S > 1
    is a multi-query verify call (consecutive positions per slot);
    ``draft`` (a DraftProfile) marks a speculative draft step. ``attn``
    selects the backend (None: the default spec, which honors
    REPRO_ATTN_BACKEND).
    Returns (y, cache, stats|None); y is in x's dtype. An fp32
    attention output (the block-sparse kernel's) meets a bf16 ``wo`` in
    fp32, as the reference promotes it, and the product is rounded once
    to x's dtype: the reference's layer scan rejects the fp32 residual
    it would make (ROADMAP.md section 3)."""
    B, S, _ = x.shape
    H, N, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // N
    rope = cfg.pos_emb == "rope" and enc_out is None and not static_cache

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        # before rope and before any pool snap: the pool codes, the scout
        # view and the prefix cache's pages all hold the normed K
        q = L.rms_norm(q, p["q_norm"])
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)

    paged = cache is not None and "k_pages" in cache
    # tensor-parallel serving: the paged decode runs head-sharded under
    # the ambient serving mesh (per-shard scout and fetched set; one
    # exact gather of o before the projection below)
    mesh = active_serving_mesh() if paged else None
    kv_dtype, kv_scale = _spec_pool(cfg, attn)
    if static_cache:
        # cross-attention at decode: the keys were cached at prefill
        k_full, v_full = cache["k"], cache["v"]
        k_pos = torch.arange(k_full.shape[1], device=x.device)
    else:
        kv_src = x if enc_out is None else enc_out
        k = torch.einsum("bsd,dnk->bsnk", kv_src, p["wk"])
        v = torch.einsum("bsd,dnk->bsnk", kv_src, p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        if cfg.qk_norm:
            k = L.rms_norm(k, p["k_norm"])
        if rope:
            k = L.apply_rope(k, positions, cfg.rope_theta)

        # only a spec that names a quantized pool snaps the prefill's
        # dense cache to its grid (as the reference): with no spec, or
        # "auto", K/V are written as projected
        if (mode == "prefill" and cache is not None and not paged
                and enc_out is None and attn is not None
                and attn.kv_dtype in ("int8", "fp8_v")
                and attn.kv_scale != "absmax"):
            ib = pool_int_bits(cfg.hdp)
            k = roundtrip_pool(k, ib).to(k.dtype)
            v = (to_fp8_e4m3(v) if attn.kv_dtype == "fp8_v"
                 else roundtrip_pool(v, ib)).to(v.dtype)

        if paged:
            if mode != "decode" or positions.dim() != 2:
                raise ValueError("the paged pool is a decode-time serving "
                                 "layout")
            ps = cache["k_pages"].shape[1]
            nP = page_table.shape[1]
            pidx = resolve_write_pages(positions, page_table, ps,
                                       write_floor)
            # in place: the per-layer pool views alias the engine's pool;
            # under tensor-parallel serving it holds this rank's heads
            _paged_write(cfg, cache, local_heads(k, 2, mesh),
                         local_heads(v, 2, mesh), pidx, positions % ps,
                         kv_scale, draft=draft)
            ar = torch.arange(nP * ps, device=x.device)
            k_pos = torch.where(ar[None, :] <= positions[:, -1:], ar, -1)
            k_pos = k_pos[:, None, None, :]              # [B,1,1,nP*ps]
            k_full = v_full = None                       # read via the table
        elif cache is not None and positions.dim() == 2 and enc_out is None:
            if mode != "decode":
                raise ValueError("per-slot positions are a decode-time "
                                 "shape")
            # per-slot decode into the dense slot cache: each row writes
            # at its own offset (clamped into the cache, as a dynamic
            # update slice is)
            smax = cache["k"].shape[1]
            p0 = torch.clamp(positions[:, :1], 0, smax - S)
            cols = p0 + torch.arange(S, device=x.device)
            rows = torch.arange(B, device=x.device)[:, None]
            cache["k"][rows, cols] = k.to(cache["k"].dtype)
            cache["v"][rows, cols] = v.to(cache["v"].dtype)
            k_full, v_full = cache["k"], cache["v"]
            ar = torch.arange(smax, device=x.device)
            k_pos = torch.where(ar[None, :] <= positions[:, -1:], ar, -1)
            k_pos = k_pos[:, None, None, :]              # [B,1,1,Smax]
        elif cache is not None:
            if mode != "prefill" or positions.dim() != 1:
                raise ValueError("a request cache is filled by prefill "
                                 "with shared positions")
            # the cross cache takes the encoder's K/V at 0; the self cache
            # at the (consecutive) positions, written by index so that no
            # position is read back to the host
            Sk = k.shape[1]
            if enc_out is None:
                cache["k"].index_copy_(1, positions, k.to(cache["k"].dtype))
                cache["v"].index_copy_(1, positions, v.to(cache["v"].dtype))
            else:
                cache["k"][:, :Sk] = k.to(cache["k"].dtype)
                cache["v"][:, :Sk] = v.to(cache["v"].dtype)
            k_full, v_full = cache["k"], cache["v"]
            k_pos = torch.arange(k_full.shape[1], device=x.device)
            if enc_out is None:
                k_pos = torch.where(k_pos <= positions[-1], k_pos, -1)
        else:
            k_full, v_full = k, v
            k_pos = (positions if enc_out is None
                     else torch.arange(k.shape[1], device=x.device))

    qg = q.reshape(B, S, N, G, hd).permute(0, 2, 3, 1, 4)   # [B,N,G,S,hd]
    q_pos = positions[:, None, None, :] if positions.dim() == 2 else positions
    is_cross = enc_out is not None or static_cache
    call = build_attn_call(
        cfg, mode=mode, paged=paged, per_slot=positions.dim() == 2,
        self_aligned=(cache is None and not is_cross
                      and positions.dim() == 1),
        cross=is_cross, causal=causal, collect_stats=collect_stats,
        draft=draft if mode == "decode" else None,
        verify=mode == "decode" and S > 1 and not is_cross,
        kv_scale=kv_scale)
    if mesh is not None:
        o, stats = tp_paged_attention(
            qg, call, attn, q_pos=q_pos, k_pos=k_pos, cache=cache,
            page_table=page_table, mesh=mesh)
    else:
        o, stats = attention(qg, k_full, v_full, call, spec=attn,
                             q_pos=q_pos, k_pos=k_pos,
                             cache=cache if paged else None,
                             page_table=page_table)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    dt = torch.promote_types(o.dtype, p["wo"].dtype)
    y = torch.einsum("bshk,hkd->bsd", o.to(dt), p["wo"].to(dt))
    return y.to(x.dtype), cache, stats
