"""Multi-head GQA attention with HDP.

PyTorch counterpart of ``repro.models.attention``. ``attn_apply``
projects, applies rope, describes the call with ``build_attn_call`` and
dispatches it through the ``repro_torch.attention`` registry. The paths
behind the registry's backends:

* ``chunked_attention`` — exact attention as an online softmax over KV
  chunks (``xla_dense`` prefill, the HDP-off path without a kernel);
* ``hdp_prefill_attention`` — the two-pass blockwise HDP (integer scout,
  then approximate attention on surviving blocks), used for prefill into
  a dense request cache (``xla_hdp``). A quantized-pool engine first
  snaps K/V to the pool grid, so prefill and the int8 decode see the
  same K;
* ``hdp_paged_decode_attention`` — decode over the int8 block-paged
  pool: stage 1 streams the int8 scout view of every allocated page,
  stage 2 keeps the pages some head still needs (Fetch-Upon-Mask), and
  stage 3 runs on those pages only, in the gather-free paged FUM kernel
  (``pallas_paged_decode``) or the block-sparse kernel on a densified
  gather (``pallas_hdp_block``).

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
from repro_torch.core.quant import (decode_pool, encode_pool, pool_int_bits,
                                    pool_view_finite, quantize_and_split,
                                    quantize_fixed, roundtrip_pool)
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.kernels.ref import keep_mask_to_indices
from repro_torch.models import layers as L

_NEG = -1e30
F32 = torch.float32

_UNPORTED = "is not ported yet (ROADMAP.md section 1, item 1)"


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
    return p


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


# ----------------------------------------------------------------- HDP path
def hdp_prefill_attention(q, k, v, *, q_pos, k_pos, hdp: HDPConfig,
                          window: int = 0, return_stats: bool = False):
    """Two-pass blockwise HDP (Alg. 2 on block_q x block_k tiles).

    Pass A: integer scout per q-block -> theta, row threshold, keep
    mask, head importance. Pass B: approximate attention (QK^T - FQ FK^T)
    on surviving blocks. Python loops over q-blocks take the place of
    the reference's ``lax.scan``."""
    if hdp.approx_softmax:
        raise NotImplementedError(
            "approx_softmax is not ported yet (ROADMAP.md section 1, item 5)")
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


def _paged_scout(q, k_pool, table, *, q_pos, k_pos, hdp: HDPConfig,
                 window: int = 0):
    """Stages 1 and 2 over an int8 pool.

    Stage 1 reads the finite static-grid view of every allocated page's
    codes (poison sentinels -> 0) and runs the decode scout; stage 2 ORs
    ``keep & head_kept`` over heads into the per-row page fetch list.
    Returns (qq, fq, keep, bvalid, theta, theta_head, head_kept,
    fetched)."""
    B = q.shape[0]
    nP = table.shape[1]
    ps, N, hd = k_pool.shape[1:]
    k_fin = pool_view_finite(k_pool[table.long()], hdp.int_bits)
    ik = torch.trunc(k_fin.reshape(B, nP * ps, N, hd))
    qq, iq, fq = _fixed_split(q, hdp)
    s_int = _einsum_f32("bngqh,bsnh->bngqs", iq, ik)
    valid = _mask_bias(q_pos, k_pos, hdp.causal, window)
    keep, bvalid, theta, theta_head, head_kept = decode_scout(s_int, valid,
                                                             hdp)
    # a page holds every kv head: fetch it if any head still needs it;
    # early-gated heads (output zeroed) demand nothing
    fetched = (keep & head_kept[..., None]).any(dim=2).any(dim=1)  # [B, nP]
    return qq, fq, keep, bvalid, theta, theta_head, head_kept, fetched


def _fetch_list(fetched, table, keep, q_pos):
    """Compress the fetch mask into the kernel's page lists.

    Kept pages in ascending logical order, padded with the scratch page
    0 past each row's count: (page_ids [B,nP], logical [B,nP], counts
    [B], keep_in [B,nP,N,G,Sq] int32, kv_len [B])."""
    B, nP = fetched.shape
    _, N, G, _ = keep.shape
    Sq = q_pos.shape[-1]
    ar = torch.arange(nP, dtype=torch.int32, device=fetched.device)
    key = torch.where(fetched, ar[None], torch.iinfo(torch.int32).max)
    logical = torch.sort(key, dim=-1).values
    counts = fetched.sum(-1).to(torch.int32)
    in_range = ar[None] < counts[:, None]
    logical = torch.where(in_range, logical, 0)
    page_ids = torch.where(in_range, torch.gather(table, 1, logical.long()), 0)
    keep_q = keep[..., None, :].expand(B, N, G, Sq, nP)
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

    Surviving pages are dequantized into contiguous [B,H,nP*ps,hd] K
    (snapped to the fixed-point grid) and V; pruned pages' gather
    indices point at the scratch page. The page keep mask and its
    importances become per-head block lists, and every query row's valid
    extent is its own position + 1 (the aligned prefill's causal mask is
    wrong for a cached decode)."""
    B, N, G, Sq, hd = qq.shape
    nP = table.shape[1]
    ps = k_pool.shape[1]
    H = N * G
    gather = torch.where(fetched, table, 0).long()            # pruned -> 0
    k = decode_pool(k_pool[gather], k_scale[gather][:, :, None, :, None])
    v = decode_pool(v_pool[gather], v_scale[gather][:, :, None, :, None])

    def per_head(x):   # [B,nP,ps,N,hd] -> [B,H,nP*ps,hd]
        x = x.reshape(B, nP * ps, N, hd).transpose(1, 2)
        return x.repeat_interleave(G, dim=1).contiguous()

    kq = per_head(quantize_fixed(k, hdp.int_bits, hdp.frac_bits))
    kv_idx, counts = keep_mask_to_indices(
        keep.reshape(B, H, 1, nP), theta.reshape(B, H, 1, nP), nP)
    lens = (q_pos.reshape(B, Sq)[:, :1] + 1).expand(B, H).to(torch.int32)
    out = hdp_block_sparse_attention(
        qq.reshape(B, H, Sq, hd).contiguous(), kq, per_head(v), kv_idx,
        counts, head_kept.reshape(B, H), causal=False, approx=hdp.approx,
        block_q=max(8, Sq), block_k=ps, score_scale=1.0, kv_len=lens)
    return out.reshape(B, N, G, Sq, hd)


#: stage-3 implementations of the paged decode that the port has
STAGE3 = ("pallas_paged", "pallas_block")


def hdp_paged_decode_attention(q, k_pool, v_pool, table, *, q_pos, k_pos,
                               hdp: HDPConfig, k_scale, v_scale,
                               window: int = 0, return_stats: bool = False,
                               stage3: str = "pallas_paged"):
    """HDP decode over the int8 block-paged pool (static ``grid`` scale).

    q [B,N,G,Sq,hd]; k/v_pool [P,ps,N,hd] int8 codes (page 0 is the
    scratch page); k/v_scale [P,N] fp32 per-page scales; table [B,nP]
    int32 page table (0-padded); q_pos [B,1,1,Sq], k_pos [B,1,1,nP*ps].
    ``stage3`` selects stages 2-3: "pallas_paged", the gather-free FUM
    kernel, or "pallas_block", the block-sparse kernel on a densified
    gather (single-query decode only). The reference's "xla" stage 3 is
    not ported yet (ROADMAP.md section 1, item 1).
    Returns (out [B,N,G,Sq,hd] in q's dtype, stats or None)."""
    if k_pool.dtype != torch.int8:
        raise NotImplementedError(
            f"{k_pool.dtype} pools: only the int8 grid pool is ported "
            "(ROADMAP.md section 1: fp32 and fp8_v pools)")
    if window:
        raise NotImplementedError(f"windowed paged decode {_UNPORTED}")
    if stage3 not in STAGE3:
        raise NotImplementedError(
            f"paged decode stage3={stage3!r} is not ported yet (ROADMAP.md "
            f"section 1, item 1); the port has {STAGE3}")
    if stage3 == "pallas_block" and q.shape[3] != 1:
        raise ValueError("the densifying block stage serves single-query "
                         "decode only")
    qq, _, keep, bvalid, theta, theta_head, head_kept, fetched = \
        _paged_scout(q, k_pool, table, q_pos=q_pos, k_pos=k_pos, hdp=hdp)
    if stage3 == "pallas_paged":
        out = _paged_fum_kernel_stage3(qq, k_pool, v_pool, table, keep,
                                       head_kept, q_pos, fetched, hdp=hdp,
                                       k_scale=k_scale, v_scale=v_scale)
    else:
        out = _paged_block_kernel_stage3(qq, k_pool, v_pool, table, keep,
                                         theta, head_kept, q_pos, fetched,
                                         hdp=hdp, k_scale=k_scale,
                                         v_scale=v_scale)
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
                    causal: bool = True, collect_stats: bool = False,
                    verify: bool = False) -> AttnCall:
    """The AttnCall ``attn_apply`` dispatches on. The serving engine uses
    the same function to report the resolved backend per phase, so the
    report cannot drift from the dispatch."""
    hdp = cfg.hdp
    use_hdp = hdp is not None and hdp.enabled
    return AttnCall(
        mode="decode" if mode == "decode" else "prefill",
        layout="paged" if paged else "dense",
        causal=causal,
        window=cfg.sliding_window,
        hdp=hdp.replace(causal=causal) if use_hdp else None,
        per_slot=per_slot,
        self_aligned=self_aligned,
        chunk=cfg.attn_chunk,
        needs_stats=collect_stats,
        verify=verify and mode == "decode",
    )


def attn_apply(cfg, p, x, *, mode: str, positions, cache=None,
               collect_stats: bool = False, page_table=None,
               write_floor=None, attn: Optional[AttnSpec] = None) -> Tuple:
    """Full MHA layer: project, rope, attend through the registry,
    output-project.

    mode "prefill": positions [S]; without ``cache`` this is aligned
    self-attention over the whole sequence (the full-sequence kernels'
    call); ``cache`` is this layer's dense request cache {"k","v"}
    [B,Smax,N,hd] of an int8-pool engine, written in place at
    positions[0] with K/V snapped to the pool grid.
    mode "decode": positions [B,S] per slot; ``cache`` is this layer's
    paged pool {"k_pages","v_pages","k_scale","v_scale"}, written in
    place (the K/V scatter) before attention reads it; ``write_floor``
    [B] fences shared prefix pages. ``attn`` selects the backend (None:
    the default spec, which honors REPRO_ATTN_BACKEND).
    Returns (y, cache, stats|None); y is in x's dtype. An fp32
    attention output (the block-sparse kernel's) meets a bf16 ``wo`` in
    fp32, as the reference promotes it, and the product is rounded once
    to x's dtype: the reference's layer scan rejects the fp32 residual
    it would make (ROADMAP.md section 3)."""
    B, S, _ = x.shape
    H, N, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // N

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    paged = cache is not None and "k_pages" in cache
    if mode == "prefill" and cache is not None:
        # round-trip K/V through the pool grid BEFORE the request-cache
        # write: prefill attention and the int8 pool insert then see one
        # set of values
        ib = pool_int_bits(cfg.hdp)
        k = roundtrip_pool(k, ib).to(k.dtype)
        v = roundtrip_pool(v, ib).to(v.dtype)

    if paged:
        if mode != "decode" or positions.dim() != 2:
            raise ValueError("the paged pool is a decode-time serving layout")
        ps = cache["k_pages"].shape[1]
        nP = page_table.shape[1]
        pidx = resolve_write_pages(positions, page_table, ps, write_floor)
        off = positions % ps
        ib = pool_int_bits(cfg.hdp)
        # in place: the per-layer pool views alias the engine's pool
        cache["k_pages"][pidx.long(), off.long()] = encode_pool(k, ib)
        cache["v_pages"][pidx.long(), off.long()] = encode_pool(v, ib)
        ar = torch.arange(nP * ps, device=x.device)
        k_pos = torch.where(ar[None, :] <= positions[:, -1:], ar, -1)
        k_pos = k_pos[:, None, None, :]                  # [B,1,1,nP*ps]
        k_full = v_full = None                           # read via the table
    elif cache is not None:
        if mode != "prefill" or positions.dim() != 1:
            raise NotImplementedError(f"dense-cache decode {_UNPORTED}")
        pos0 = int(positions[0])
        cache["k"][:, pos0:pos0 + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos0:pos0 + S] = v.to(cache["v"].dtype)
        k_full, v_full = cache["k"], cache["v"]
        k_pos = torch.arange(k_full.shape[1], device=x.device)
        k_pos = torch.where(k_pos <= positions[-1], k_pos, -1)
    else:
        k_full, v_full, k_pos = k, v, positions

    qg = q.reshape(B, S, N, G, hd).permute(0, 2, 3, 1, 4)   # [B,N,G,S,hd]
    q_pos = positions[:, None, None, :] if positions.dim() == 2 else positions
    call = build_attn_call(
        cfg, mode=mode, paged=paged, per_slot=positions.dim() == 2,
        self_aligned=cache is None and positions.dim() == 1,
        collect_stats=collect_stats, verify=mode == "decode" and S > 1)
    o, stats = attention(qg, k_full, v_full, call, spec=attn, q_pos=q_pos,
                         k_pos=k_pos, cache=cache if paged else None,
                         page_table=page_table)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    dt = torch.promote_types(o.dtype, p["wo"].dtype)
    y = torch.einsum("bshk,hkd->bsd", o.to(dt), p["wo"].to(dt))
    return y.to(x.dtype), cache, stats
