"""Multi-head GQA attention with HDP, for the serving path.

PyTorch counterpart of ``repro.models.attention`` limited to the two
branches the serving engine takes for a dense transformer:

* prefill into a dense request cache — ``hdp_prefill_attention``, the
  two-pass blockwise HDP (integer scout, then approximate attention on
  surviving blocks). A quantized-pool engine first snaps K/V to the pool
  grid, so prefill and the int8 decode see the same K;
* decode over the int8 block-paged pool — ``hdp_paged_decode_attention``:
  stage 1 streams the int8 scout view of every allocated page, stage 2
  keeps the pages some head still needs (Fetch-Upon-Mask), stage 3 runs
  the gather-free paged FUM kernel on those pages only.

Tensor conventions: activations x [B, S, D]; q [B, N, G, Sq, hd] where
N = kv heads and G = query group size; k/v [B, Sk, N, hd]. The internals
run in fp32 whatever the model dtype, as in the reference, and the
output is cast back to q's dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import blocking
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import calibrated_split, decode_scout
from repro_torch.core.quant import (encode_pool, pool_int_bits,
                                    pool_view_finite, quantize_and_split,
                                    roundtrip_pool)
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.models import layers as L

_NEG = -1e30
F32 = torch.float32

_UNPORTED = ("is not ported yet (ROADMAP.md section 1: the attention "
             "registry and the remaining attention paths)")


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


# ----------------------------------------------------------------- HDP path
def hdp_prefill_attention(q, k, v, *, q_pos, k_pos, hdp: HDPConfig,
                          window: int = 0, return_stats: bool = False):
    """Two-pass blockwise HDP (Alg. 2 on block_q x block_k tiles).

    Pass A: integer scout per q-block -> theta, row threshold, keep
    mask, head importance. Pass B: approximate attention (QK^T - FQ FK^T)
    on surviving blocks. Python loops over q-blocks take the place of
    the reference's ``lax.scan``."""
    if hdp.approx_softmax:
        raise NotImplementedError(f"approx_softmax {_UNPORTED}")
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
    Returns (qq, fq, keep, bvalid, theta_head, head_kept, fetched)."""
    B = q.shape[0]
    nP = table.shape[1]
    ps, N, hd = k_pool.shape[1:]
    k_fin = pool_view_finite(k_pool[table.long()], hdp.int_bits)
    ik = torch.trunc(k_fin.reshape(B, nP * ps, N, hd))
    qq, iq, fq = _fixed_split(q, hdp)
    s_int = _einsum_f32("bngqh,bsnh->bngqs", iq, ik)
    valid = _mask_bias(q_pos, k_pos, hdp.causal, window)
    keep, bvalid, _, theta_head, head_kept = decode_scout(s_int, valid, hdp)
    # a page holds every kv head: fetch it if any head still needs it;
    # early-gated heads (output zeroed) demand nothing
    fetched = (keep & head_kept[..., None]).any(dim=2).any(dim=1)  # [B, nP]
    return qq, fq, keep, bvalid, theta_head, head_kept, fetched


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


def hdp_paged_decode_attention(q, k_pool, v_pool, table, *, q_pos, k_pos,
                               hdp: HDPConfig, k_scale, v_scale,
                               window: int = 0, return_stats: bool = False):
    """HDP decode over the int8 block-paged pool (static ``grid`` scale).

    q [B,N,G,Sq,hd]; k/v_pool [P,ps,N,hd] int8 codes (page 0 is the
    scratch page); k/v_scale [P,N] fp32 per-page scales; table [B,nP]
    int32 page table (0-padded); q_pos [B,1,1,Sq], k_pos [B,1,1,nP*ps].
    Returns (out [B,N,G,Sq,hd] in q's dtype, stats or None)."""
    if k_pool.dtype != torch.int8:
        raise NotImplementedError(
            f"{k_pool.dtype} pools: only the int8 grid pool is ported "
            "(ROADMAP.md section 1: fp32 and fp8_v pools)")
    if window:
        raise NotImplementedError(f"windowed paged decode {_UNPORTED}")
    qq, _, keep, bvalid, theta_head, head_kept, fetched = _paged_scout(
        q, k_pool, table, q_pos=q_pos, k_pos=k_pos, hdp=hdp)
    out = _paged_fum_kernel_stage3(qq, k_pool, v_pool, table, keep,
                                   head_kept, q_pos, fetched, hdp=hdp,
                                   k_scale=k_scale, v_scale=v_scale)
    stats = None
    if return_stats:
        alloc = torch.clamp((table > 0).to(F32).sum(-1), min=1.0)   # [B]
        page_frac = (fetched & (table > 0)).to(F32).sum(-1) / alloc
        stats = {**_block_sparsity_stats(keep, bvalid, head_kept),
                 "page_sparsity": 1.0 - torch.clamp(page_frac, max=1.0),
                 "theta_head": theta_head}
    return out.to(q.dtype), stats


# --------------------------------------------------------------- full layer
def attn_apply(cfg, p, x, *, mode: str, positions, cache=None,
               collect_stats: bool = False, page_table=None,
               write_floor=None) -> Tuple:
    """Full MHA layer: project, rope, HDP-attend, output-project.

    mode "prefill": positions [S]; ``cache`` (optional) is this layer's
    dense request cache {"k","v"} [B,Smax,N,hd] of an int8-pool engine,
    written in place at positions[0] with K/V snapped to the pool grid.
    mode "decode": positions [B,S] per slot; ``cache`` is this layer's
    paged pool {"k_pages","v_pages","k_scale","v_scale"}, written in
    place (the K/V scatter) before attention reads it; ``write_floor``
    [B] fences shared prefix pages. Returns (y, cache, stats|None)."""
    hdp = cfg.hdp
    if hdp is None or not hdp.enabled:
        raise NotImplementedError(f"HDP-off attention {_UNPORTED}")
    B, S, _ = x.shape
    H, N, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // N
    window = cfg.sliding_window

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
        ib = pool_int_bits(hdp)
        k = roundtrip_pool(k, ib).to(k.dtype)
        v = roundtrip_pool(v, ib).to(v.dtype)

    if paged:
        if mode != "decode" or positions.dim() != 2:
            raise ValueError("the paged pool is a decode-time serving layout")
        ps = cache["k_pages"].shape[1]
        nP = page_table.shape[1]
        pidx = resolve_write_pages(positions, page_table, ps, write_floor)
        off = positions % ps
        ib = pool_int_bits(hdp)
        # in place: the per-layer pool views alias the engine's pool
        cache["k_pages"][pidx.long(), off.long()] = encode_pool(k, ib)
        cache["v_pages"][pidx.long(), off.long()] = encode_pool(v, ib)
        ar = torch.arange(nP * ps, device=x.device)
        k_pos = torch.where(ar[None, :] <= positions[:, -1:], ar, -1)
        k_pos = k_pos[:, None, None, :]                  # [B,1,1,nP*ps]
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
    hdp_eff = hdp.replace(causal=True)
    if paged:
        o, stats = hdp_paged_decode_attention(
            qg, cache["k_pages"], cache["v_pages"], page_table,
            q_pos=q_pos, k_pos=k_pos, hdp=hdp_eff, window=window,
            k_scale=cache["k_scale"], v_scale=cache["v_scale"],
            return_stats=collect_stats)
    else:
        o, stats = hdp_prefill_attention(
            qg, k_full, v_full, q_pos=q_pos, k_pos=k_pos, hdp=hdp_eff,
            window=window, return_stats=collect_stats)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return y, cache, stats
