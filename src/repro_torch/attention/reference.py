"""The ``reference`` backend: materializing oracle for every call shape.

PyTorch counterpart of ``repro.attention.reference``: the model-layout
generalization of the paper's Algorithm 2 (q [B,N,G,Sq,hd]; k/v
[B,Sk,N,hd]) for every call the registry can describe — prefill and
decode, dense and paged layouts, causal/window masks, per-slot
positions, HDP on or off, draft and verify decode. Everything is
computed densely with explicit masks (no loops, no kernels, no
fetch-upon-mask gather), so it is the ground truth the other backends
are held against and the last resort of the auto chain. With
``approx_softmax`` the HDP prefill takes the paper's polynomial softmax,
as the reference's does; decode takes the exact softmax either way, as
the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.attention.registry import register_backend
from repro_torch.attention.spec import AttnCall
from repro_torch.attention.stats import AttnStats
from repro_torch.core import blocking
from repro_torch.core.hdp import calibrated_split, decode_scout
from repro_torch.core.quant import (FRAC_SCOUT_SCALE, decode_pool,
                                    pool_int_bits, pool_view_finite)

F32 = torch.float32


def _supports(call: AttnCall) -> bool:
    del call
    return True  # the oracle serves every valid AttnCall


def _pad_axis(x, axis, target):
    pad = target - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_pos(pos, target):
    """Pad a position array along its last axis; pads become -1."""
    return _pad_axis(pos + 1, pos.dim() - 1, target) - 1


def _densify(cache, page_table, int_bits=4):
    """Gather the FULL page pools into contiguous [B, nP*ps, N, hd] K and
    V, plus the integer scout view of K (int8 pools: from the codes,
    poison -> 0; fp32 pools: their ``k_scout`` copy, or None).

    The oracle reads everything — fetch-upon-mask is a performance
    property of the production backends, not part of the semantics."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    B, nP = page_table.shape
    ps, N, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    tbl = page_table.long()
    if kp.dtype == torch.int8:
        ks = cache["k_scale"][tbl][:, :, None, :, None]
        vs = cache["v_scale"][tbl][:, :, None, :, None]
        k = decode_pool(kp[tbl], ks).reshape(B, nP * ps, N, hd)
        vg = vp[tbl]
        v = (vg.to(F32) * vs if vg.dtype != torch.int8
             else decode_pool(vg, vs)).reshape(B, nP * ps, N, hd)
        ik = torch.trunc(pool_view_finite(kp[tbl], int_bits).reshape(
            B, nP * ps, N, hd))
        return k, v, ik
    k = kp[tbl].reshape(B, nP * ps, N, hd)
    v = vp[tbl].reshape(B, nP * ps, N, hd)
    ik = None
    if "k_scout" in cache:
        ik = cache["k_scout"][tbl].reshape(B, nP * ps, N, hd).to(F32)
    return k, v, ik


def _mean(x, dims=None):
    """Mean as sum times the reciprocal count: XLA compiles the
    reference's ``.mean()`` (a division by a constant) so."""
    if dims is None:
        return x.sum() * (1.0 / x.numel())
    n = 1
    for d in dims:
        n *= x.shape[d]
    return x.sum(dims) * (1.0 / n)


def _sparsity_stats(keep, bvalid, head_kept):
    kept = (keep & bvalid).to(F32).sum()
    tot = torch.clamp(bvalid.expand(keep.shape).to(F32).sum(), min=1.0)
    return 1.0 - kept / tot, 1.0 - _mean(head_kept.to(F32))


def _sparsity_stats_per_slot(keep, bvalid, head_kept):
    """Decode-mode stats keep the batch dim ([B] leaves), so the serving
    engine can mask parked slots."""
    ax = tuple(range(1, keep.dim()))
    kept = (keep & bvalid).to(F32).sum(ax)
    tot = torch.clamp(bvalid.expand(keep.shape).to(F32).sum(ax), min=1.0)
    hax = tuple(range(1, head_kept.dim()))
    return 1.0 - kept / tot, 1.0 - _mean(head_kept.to(F32), hax)


def _dense_exact(q, k, v, valid):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bngqh,bsnh->bngqs", q.to(F32), k.to(F32)) * scale
    p = blocking.masked_softmax(s, valid)
    return torch.einsum("bngqs,bsnh->bngqh", p, v.to(F32))


def _hdp_prefill(q, k, v, call, q_pos, k_pos):
    """Blockwise scout on the (bq x bk) grid — Algorithm 2, fully dense."""
    from repro_torch.models.attention import _mask_bias
    hdp = call.hdp
    B, N, G, Sq, hd = q.shape
    Sk = k.shape[1]
    bq, bk = hdp.block_q, hdp.block_k
    Sqp, Skp = _ceil_to(Sq, bq), _ceil_to(Sk, bk)
    scale = 1.0 / (hd ** 0.5)

    sq, qq, iq, fq = calibrated_split(_pad_axis(q, 3, Sqp).to(F32), hdp)
    sk, kq, ik, fk = calibrated_split(_pad_axis(k, 1, Skp).to(F32), hdp)
    vp = _pad_axis(v, 1, Skp)
    valid = _mask_bias(_pad_pos(q_pos, Sqp), _pad_pos(k_pos, Skp),
                       call.causal, call.window)

    s_int = torch.einsum("bngqh,bsnh->bngqs", iq, ik)
    theta = blocking.block_abs_sum(torch.where(valid, s_int, 0.0), bq, bk)
    bvalid = blocking.block_abs_sum(valid.to(F32), bq, bk) > 0
    if hdp.block_pruning:
        thr = blocking.row_threshold(theta, hdp.rho_b, bvalid)
        keep = blocking.block_keep_mask(theta, thr, bvalid)
    else:
        keep = bvalid.expand(theta.shape)

    theta_head = torch.where(bvalid, theta, 0.0).sum(dim=(-2, -1))
    if hdp.normalize_head_score:
        n_valid = valid.to(F32).sum(dim=(-2, -1))
        theta_head = theta_head / torch.clamp(n_valid, min=1.0)
    head_kept = (theta_head > hdp.tau_h) if hdp.head_pruning \
        else torch.ones_like(theta_head, dtype=torch.bool)

    s = torch.einsum("bngqh,bsnh->bngqs", qq, kq)
    if hdp.approx:
        s = s - torch.einsum("bngqh,bsnh->bngqs", fq, fk)
    s = s * (scale / (sq * sk))
    keep_e = blocking.expand_block_mask(keep, bq, bk) & valid
    softmax = (blocking.approx_softmax if hdp.approx_softmax
               else blocking.masked_softmax)
    p = softmax(s, keep_e)
    out = torch.einsum("bngqs,bsnh->bngqh", p, vp.to(F32))
    out = out[:, :, :, :Sq] * head_kept[..., None, None].to(F32)

    stats = None
    if call.needs_stats:
        bs, hs = _sparsity_stats(keep, bvalid, head_kept)
        stats = AttnStats(bs, hs, theta_head=theta_head)
    return out, stats


def _hdp_decode(q, k, v, call, q_pos, k_pos, *, ik=None, fixed_grid=False,
                page_table=None):
    """Pooled-row scout over KV blocks/pages (decode_scout semantics);
    verify calls scout per query row, draft calls score with the
    profile's draft approximation."""
    from repro_torch.models.attention import (_expand_keep, _fixed_split,
                                              _head_gate, _mask_bias)
    hdp = call.hdp
    bk = hdp.block_k
    Sk = k.shape[1]
    Skp = _ceil_to(Sk, bk)
    scale = 1.0 / (q.shape[-1] ** 0.5)

    kp = _pad_axis(k, 1, Skp).to(F32)
    if fixed_grid:
        qq, iq, fq = _fixed_split(q, hdp)
        kq, _, fk = _fixed_split(kp, hdp)
        rescale = 1.0
    else:
        sq, qq, iq, fq = calibrated_split(q.to(F32), hdp)
        sk, kq, ik_c, fk = calibrated_split(kp, hdp)
        ik = ik_c if ik is None else ik
        rescale = 1.0 / (sq * sk)
    if ik is None:
        ik = _fixed_split(kp, hdp)[1]
    ik = _pad_axis(ik, 1, Skp)
    vp = _pad_axis(v, 1, Skp)

    valid = _mask_bias(q_pos, _pad_pos(k_pos, Skp), call.causal, call.window)
    s_int = torch.einsum("bngqh,bsnh->bngqs", iq, ik)
    keep, bvalid, _, theta_head, head_kept = decode_scout(
        s_int, valid, hdp, per_query=call.verify)

    if call.draft is not None and call.draft.scores != "approx":
        s = s_int
        if call.draft.scores == "scout":
            fkh = torch.round(fk * FRAC_SCOUT_SCALE) / FRAC_SCOUT_SCALE
            s = s + torch.einsum("bngqh,bsnh->bngqs", fq, ik) \
                + torch.einsum("bngqh,bsnh->bngqs", iq, fkh)
    else:
        s = torch.einsum("bngqh,bsnh->bngqs", qq, kq)
        if hdp.approx:
            s = s - torch.einsum("bngqh,bsnh->bngqs", fq, fk)
    s = s * (scale * rescale)
    keep_e = _expand_keep(keep, bk, valid, s.dim())
    p = blocking.masked_softmax(s, keep_e)
    out = torch.einsum("bngqs,bsnh->bngqh", p, vp.to(F32))
    out = _head_gate(out, head_kept.to(F32))

    stats = None
    if call.needs_stats:
        bs, hs = _sparsity_stats_per_slot(keep, bvalid, head_kept)
        page_sp = None
        if page_table is not None:
            fetched = (keep & head_kept[..., None]).any(
                dim=tuple(range(1, keep.dim() - 1)))
            alloc = torch.clamp((page_table > 0).to(F32).sum(-1), min=1.0)
            page_sp = 1.0 - torch.clamp(
                (fetched & (page_table > 0)).to(F32).sum(-1) / alloc,
                max=1.0)
        stats = AttnStats(bs, hs, theta_head=theta_head,
                          page_sparsity=page_sp)
    return out, stats


@register_backend("reference", supports=_supports, priority=0,
                  tags=("reference",))
def run_reference(q, k, v, call: AttnCall, *, q_pos, k_pos, cache=None,
                  page_table=None):
    from repro_torch.models.attention import _mask_bias
    ik = None
    fixed_grid = False
    if call.layout == "paged":
        k, v, ik = _densify(cache, page_table, pool_int_bits(call.hdp))
        fixed_grid = True  # write-time scout copy => static fixed-point grid
    if call.hdp is None:
        valid = _mask_bias(q_pos, k_pos, call.causal, call.window)
        out = _dense_exact(q, k, v, valid)
        return out.to(q.dtype), None
    if call.mode == "decode":
        out, stats = _hdp_decode(q, k, v, call, q_pos, k_pos, ik=ik,
                                 fixed_grid=fixed_grid,
                                 page_table=page_table)
    else:
        out, stats = _hdp_prefill(q, k, v, call, q_pos, k_pos)
    return out.to(q.dtype), stats
