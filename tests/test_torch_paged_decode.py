"""Port parity of the paged FUM decode: the plain version of the kernel,
its poison contract, and the whole decode stage pipeline, against the
JAX package on the same numpy inputs.

* ``hdp_paged_fum_decode_ref`` vs the Pallas kernel run in interpret
  mode: int8 and fp32 pools, Sq 1 and 3, atol 1e-5 (both accumulate in
  fp32; only the order of the sums differs).
* The FUM contract of ``tests/test_kv_quant.py``: int8 pools are
  bit-identical to fp32 pools holding the decoded values, poisoning
  pruned pages cannot change the output, a NaN-scaled fetched page
  trips NaN.
* ``hdp_paged_decode_attention`` vs the reference's: keep mask, fetch
  list and stats exactly equal, output within 1e-5.

The card runs the CUDA kernel against the same plain version in
``chip_smoke.py``; here every wrapper call takes the plain path because
the tensors lie on the CPU.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.hdp_paged_decode as jkern
from repro.core.config import HDPConfig as JHDPConfig
from repro.core.hdp import decode_scout as j_decode_scout
from repro.core.quant import pool_view_finite as j_pool_view_finite
from repro.models.attention import _fixed_split as j_fixed_split
from repro.models.attention import _mask_bias as j_mask_bias
from repro.models.attention import \
    resolve_write_pages as j_resolve_write_pages
from repro.models.attention import \
    hdp_paged_decode_attention as j_paged_attention
from repro_torch.core.config import HDPConfig
from repro_torch.core.quant import (POISON_CODE, decode_pool, pool_scale,
                                    quantize_fixed)
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
from repro_torch.models.attention import (_fetch_list, _paged_scout,
                                          hdp_paged_decode_attention,
                                          resolve_write_pages)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

B, N, G, HD, PS, NP = 2, 2, 2, 8, 4, 8
P = 1 + B * NP
SK = NP * PS
IB = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _kernel_inputs(seed, Sq, quantized):
    """Numpy inputs of the kernel the way stage 2 builds them: distinct
    pages per row, a keep mask, ascending page lists padded with the
    scratch page past each row's count."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 2, (B, N, G, Sq, HD)).astype(np.float32)
    qq = np.asarray(quantize_fixed(_t(q)))
    if quantized:
        kp = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
        ks = np.full((P, N), pool_scale(IB), np.float32)
        vs = ks.copy()
    else:
        kp = rng.normal(0, 4, (P, PS, N, HD)).astype(np.float32)
        vp = rng.normal(0, 1, (P, PS, N, HD)).astype(np.float32)
        ks = vs = None
    table = np.arange(1, P, dtype=np.int32).reshape(B, NP)
    live = rng.random((B, NP)) < 0.6
    keep = (rng.random((B, NP, N, G, Sq)) < 0.6) & live[:, :, None, None, None]
    fetched = keep.reshape(B, NP, -1).any(-1)
    page_ids = np.zeros((B, NP), np.int32)
    logical = np.zeros((B, NP), np.int32)
    keep_in = np.zeros((B, NP, N, G, Sq), np.int32)
    counts = fetched.sum(-1).astype(np.int32)
    for b in range(B):
        idx = np.nonzero(fetched[b])[0]
        logical[b, :len(idx)] = idx
        page_ids[b, :len(idx)] = table[b, idx]
        keep_in[b, :len(idx)] = keep[b, idx]
    kv_len = np.array([SK - Sq + 1, SK // 2 + 1], np.int32)
    return dict(qq=qq, k_pool=kp, v_pool=vp, page_ids=page_ids,
                logical=logical, counts=counts, keep=keep_in, kv_len=kv_len,
                k_scale=ks, v_scale=vs)


def _torch_args(d):
    args = tuple(_t(d[k]) for k in ("qq", "k_pool", "v_pool", "page_ids",
                                    "logical", "counts", "keep", "kv_len"))
    kw = {k: (None if d[k] is None else _t(d[k]))
          for k in ("k_scale", "v_scale")}
    return args, kw


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp32"])
@pytest.mark.parametrize("Sq", [1, 3])
def test_ref_matches_pallas_kernel(quantized, Sq):
    d = _kernel_inputs(Sq, Sq, quantized)
    args, kw = _torch_args(d)
    got = hdp_paged_fum_decode_ref(*args, **kw).numpy()
    jkw = {k: (None if d[k] is None else jnp.asarray(d[k]))
           for k in ("k_scale", "v_scale")}
    want = np.asarray(jkern.hdp_paged_fum_decode(
        *(jnp.asarray(d[k]) for k in ("qq", "k_pool", "v_pool", "page_ids",
                                      "logical", "counts", "keep", "kv_len")),
        interpret=True, **jkw))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrapper_cpu_path_is_the_plain_version_and_validates():
    d = _kernel_inputs(4, 1, True)
    args, kw = _torch_args(d)
    before = hdp_paged_fum_decode.launches
    out = hdp_paged_fum_decode(*args, **kw)
    assert torch.equal(out, hdp_paged_fum_decode_ref(*args, **kw))
    assert hdp_paged_fum_decode.launches == before   # plain path: no launch
    with pytest.raises(ValueError, match="float32 pools expected"):
        hdp_paged_fum_decode(*args)                  # codes without scales
    with pytest.raises(ValueError, match="keep"):
        hdp_paged_fum_decode(*args[:6], args[6][:, :2].contiguous(),
                             args[7], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([args[0], args[0]], dim=-1)[..., ::2]
        hdp_paged_fum_decode(strided, *args[1:], **kw)


def test_int8_pool_bit_identical_to_fp32_of_decoded_values():
    """Power-of-two scales make every dequant exact, so an int8 pool and
    an fp32 pool holding its decoded values give the same bits."""
    d = _kernel_inputs(5, 1, True)
    args, kw = _torch_args(d)
    out_q = hdp_paged_fum_decode(*args, **kw)
    s0 = pool_scale(IB)
    k_dec = decode_pool(args[1], s0)
    v_dec = decode_pool(args[2], s0)
    out_f = hdp_paged_fum_decode(args[0], k_dec, v_dec, *args[3:])
    assert torch.equal(out_q, out_f)


@pytest.mark.parametrize("with_floor", [False, True])
def test_resolve_write_pages_fences(with_floor):
    """Write positions -> pool pages, with the scratch redirects: past
    the table width and (with a floor) below each slot's write floor."""
    rng = np.random.default_rng(2)
    table = rng.integers(1, P, (3, 5)).astype(np.int32)
    table[2, 3:] = 0                                 # unallocated columns
    pos = rng.integers(0, 7 * PS, (3, 4)).astype(np.int64)
    floor = np.array([0, 2, 4]) if with_floor else None
    got = resolve_write_pages(_t(pos), _t(table), PS,
                              None if floor is None else _t(floor))
    want = j_resolve_write_pages(jnp.asarray(pos), jnp.asarray(table), PS,
                                 None if floor is None else jnp.asarray(floor))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[pos // PS >= 5] == 0).all()


# ------------------------------------------------- the decode pipeline
def _pipeline_inputs(seed, head_pruning):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.5, (B, N, G, 1, HD)).astype(np.float32)
    kc = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
    vc = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
    scl = np.full((P, N), pool_scale(IB), np.float32)
    table = np.arange(1, P, dtype=np.int32).reshape(B, NP)
    pos = np.array([[SK - 1], [SK // 2 + 3]], np.int32)
    ar = np.arange(SK)
    k_pos = np.where(ar[None] <= pos, ar, -1)[:, None, None, :]
    q_pos = pos[:, None, None, :]
    kw = dict(block_q=1, block_k=PS, rho_b=0.5, causal=True, calib="none",
              head_pruning=head_pruning, tau_h=0.5,
              normalize_head_score=True)
    return (q, kc, vc, scl, table, q_pos, k_pos, HDPConfig(**kw),
            JHDPConfig(**kw))


@pytest.mark.parametrize("head_pruning", [False, True])
def test_scout_and_fetch_list_exact(monkeypatch, head_pruning):
    q, kc, vc, scl, table, q_pos, k_pos, hdp, jhdp = _pipeline_inputs(
        11, head_pruning)
    *_, keep, bvalid, _, theta_head, head_kept, fetched = _paged_scout(
        _t(q), _t(kc), _t(table), q_pos=_t(q_pos), k_pos=_t(k_pos), hdp=hdp)

    # the reference's stage 1 + 2, as test_kv_quant reconstructs it
    ik = jnp.trunc(j_pool_view_finite(jnp.asarray(kc)[table], IB)) \
        .reshape(B, SK, N, HD)
    _, iq, _ = j_fixed_split(jnp.asarray(q), jhdp)
    s_int = jnp.einsum("bngqh,bsnh->bngqs", iq, ik)
    valid = j_mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), True, 0)
    jkeep, jbvalid, _, jth, jhk = j_decode_scout(s_int, valid, jhdp)
    jfetched = (jkeep & jhk[..., None]).any(axis=(1, 2))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(
        bvalid.expand(keep.shape).numpy(),
        np.broadcast_to(np.asarray(jbvalid), keep.shape))
    np.testing.assert_array_equal(theta_head.numpy(), np.asarray(jth))
    np.testing.assert_array_equal(head_kept.numpy(), np.asarray(jhk))
    np.testing.assert_array_equal(fetched.numpy(), np.asarray(jfetched))
    assert 0 < int(fetched.sum()) < fetched.numel(), "need pruned pages"

    # the kernel inputs the reference's stage 3 compresses them into
    seen = {}
    orig = jkern.hdp_paged_fum_decode

    def capture(qq, k_pool, v_pool, page_ids, logical, counts, keep_in,
                kv_len, **kw):
        seen.update(page_ids=page_ids, logical=logical, counts=counts,
                    keep=keep_in, kv_len=kv_len)
        return orig(qq, k_pool, v_pool, page_ids, logical, counts, keep_in,
                    kv_len, **kw)

    monkeypatch.setattr(jkern, "hdp_paged_fum_decode", capture)
    j_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None,
        jnp.asarray(table), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), hdp=jhdp, stage3="pallas_paged",
        k_scale=jnp.asarray(scl), v_scale=jnp.asarray(scl))
    got = dict(zip(("page_ids", "logical", "counts", "keep", "kv_len"),
                   _fetch_list(fetched, _t(table), keep, _t(q_pos))))
    for name, arr in got.items():
        np.testing.assert_array_equal(arr.numpy(), np.asarray(seen[name]),
                                      err_msg=name)


@pytest.mark.parametrize("stage3", ["xla", "pallas_paged"])
@pytest.mark.parametrize("head_pruning", [False, True])
def test_paged_decode_attention_matches_reference(stage3, head_pruning):
    q, kc, vc, scl, table, q_pos, k_pos, hdp, jhdp = _pipeline_inputs(
        11, head_pruning)
    out, st = hdp_paged_decode_attention(
        _t(q), _t(kc), _t(vc), None, _t(table), q_pos=_t(q_pos),
        k_pos=_t(k_pos), hdp=hdp, k_scale=_t(scl), v_scale=_t(scl),
        return_stats=True, stage3=stage3)
    jout, jst = j_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None,
        jnp.asarray(table), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), hdp=jhdp, stage3=stage3,
        k_scale=jnp.asarray(scl), v_scale=jnp.asarray(scl),
        return_stats=True)
    assert set(st) == set(jst)
    for name in st:
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(jst[name]),
                                      err_msg=name)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


def test_fum_poison_contract():
    """Port of the int8 leg of test_kv_quant's no-DMA contract: pruned
    pages poisoned through every stage-3 channel (V codes, both scales)
    leave the output bit-identical; a NaN scale on a fetched page trips
    NaN. K codes stay intact: they are the stage-1 scout stream."""
    q, kc, vc, scl, table, q_pos, k_pos, hdp, _ = _pipeline_inputs(3, False)
    kw = dict(q_pos=_t(q_pos), k_pos=_t(k_pos), hdp=hdp)
    out, _ = hdp_paged_decode_attention(_t(q), _t(kc), _t(vc), None,
                                        _t(table), k_scale=_t(scl),
                                        v_scale=_t(scl),
                                        stage3="pallas_paged", **kw)
    assert torch.isfinite(out).all()
    *_, fetched = _paged_scout(_t(q), _t(kc), _t(table), **kw)
    pruned = table[~fetched.numpy()]
    assert pruned.size > 0, "test needs pruned pages"
    vc_bad, ks_bad, vs_bad = vc.copy(), scl.copy(), scl.copy()
    vc_bad[pruned] = POISON_CODE
    ks_bad[pruned] = np.nan
    vs_bad[pruned] = np.nan
    out_bad, _ = hdp_paged_decode_attention(
        _t(q), _t(kc), _t(vc_bad), None, _t(table), k_scale=_t(ks_bad),
        v_scale=_t(vs_bad), stage3="pallas_paged", **kw)
    assert torch.equal(out, out_bad), "poison leaked: a pruned page was read"
    vis = table[0][fetched[0].numpy()][0]
    ks_nan = scl.copy()
    ks_nan[vis] = np.nan
    out_nan, _ = hdp_paged_decode_attention(
        _t(q), _t(kc), _t(vc), None, _t(table), k_scale=_t(ks_nan),
        v_scale=_t(scl), stage3="pallas_paged", **kw)
    assert torch.isnan(out_nan[0]).any(), \
        "NaN-scale poison on a fetched page did not surface"


@pytest.mark.parametrize("head_pruning", [False, True])
def test_block_stage3_matches_reference(head_pruning):
    """``stage3="pallas_block"``: the block-sparse kernel's plain version
    on a densified gather of the surviving pages equals the reference's
    block-kernel stage (interpret mode) and its XLA stage; pruned pages
    poisoned through V codes and both scales leave it bit-identical."""
    q, kc, vc, scl, table, q_pos, k_pos, hdp, jhdp = _pipeline_inputs(
        11, head_pruning)
    kw = dict(q_pos=_t(q_pos), k_pos=_t(k_pos), hdp=hdp,
              stage3="pallas_block", return_stats=True)
    out, st = hdp_paged_decode_attention(
        _t(q), _t(kc), _t(vc), None, _t(table), k_scale=_t(scl),
        v_scale=_t(scl), **kw)
    for jstage in ("pallas_block", "xla"):
        jout, jst = j_paged_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None,
            jnp.asarray(table), q_pos=jnp.asarray(q_pos),
            k_pos=jnp.asarray(k_pos), hdp=jhdp, stage3=jstage,
            k_scale=jnp.asarray(scl), v_scale=jnp.asarray(scl),
            return_stats=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0, err_msg=jstage)
        for name in st:
            np.testing.assert_array_equal(st[name].numpy(),
                                          np.asarray(jst[name]),
                                          err_msg=name)
    *_, fetched = _paged_scout(_t(q), _t(kc), _t(table), q_pos=_t(q_pos),
                               k_pos=_t(k_pos), hdp=hdp)
    pruned = table[~fetched.numpy()]
    assert pruned.size > 0, "test needs pruned pages"
    vc_bad, ks_bad, vs_bad = vc.copy(), scl.copy(), scl.copy()
    vc_bad[pruned] = POISON_CODE
    ks_bad[pruned] = np.nan
    vs_bad[pruned] = np.nan
    out_bad, _ = hdp_paged_decode_attention(
        _t(q), _t(kc), _t(vc_bad), None, _t(table), k_scale=_t(ks_bad),
        v_scale=_t(vs_bad), **kw)
    assert torch.equal(out, out_bad), "poison leaked: a pruned page was read"
