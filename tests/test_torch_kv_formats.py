"""Port parity of the pool formats: the fp32, fp8_v and absmax pools, the
fp8 cast, and the FUM and page-chunk stage 3 on each format.

* Pools: after the same request cache is inserted into the port's
  ``PagedKVCache`` and the reference's, and after one layer's decode
  write into them (inputs on a coarse grid, so both frameworks project
  the same K/V), every pool leaf (int8 codes, fp8 V pages, unquantized
  pages, scales, the int8 scout copy) is equal exactly, and the
  attention output agrees to 1e-5 (fp32 sums in another order).
* The fp8 cast: float8_e4m3fn saturates to +/-448 in torch and is NaN
  past 464 in the reference; the port's encode follows the reference on
  every bf16 value and on a float32 sweep, in the pool insert too.
* The FUM decode's plain version on fp8 V pages and on bf16 pools
  against the JAX kernel in interpret mode, to 1e-5 (fp32 sums in
  another order; p is rounded to bf16 before p.V in both on a bf16
  pool).
* ``_paged_scan_attention`` (stage 3 "xla" over page chunks) against
  the reference's at ``page_chunk`` of 1 and 2 pages, on each pool
  format, to 1e-5, with equal stats.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.config import HDPConfig as JHDPConfig
from repro.kernels.hdp_paged_decode import hdp_paged_fum_decode as j_fum
from repro.models import attention as JA
from repro.models.attention import \
    hdp_paged_decode_attention as j_paged_attention
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.core.config import HDPConfig
from repro_torch.core.quant import pool_scale, to_fp8_e4m3
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
from repro_torch.models import attention as A
from repro_torch.models.attention import (_fetch_list,
                                          hdp_paged_decode_attention,
                                          scout_int8)
from repro_torch.serving.kv_cache import PagedKVCache

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

F8 = torch.float8_e4m3fn
PLENS = (13, 9)
BUCKET, MAX_LEN = 16, 32
POOLS = [("fp32", "grid"), ("fp8_v", "grid"), ("int8", "absmax"),
         ("fp8_v", "absmax")]


def _leaf(x):
    """A pool leaf as numpy; fp8 pages by their values (NaN == NaN)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == F8 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.float8_e4m3fn
                      else x)


def _cfgs():
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    cfg = reduced(get_config("qwen2-1.5b"))
    return (jcfg.replace(hdp=jcfg.hdp.replace(calib="none")),
            cfg.replace(hdp=cfg.hdp.replace(calib="none")))


def _grid(rng, shape, step, lo=-2, hi=2):
    """Small multiples of ``step``: products and sums of these are exact
    in fp32 in both frameworks, so both pools encode the same values."""
    return (rng.integers(lo, hi + 1, shape) * step).astype(np.float32)


@pytest.mark.parametrize("kv_dtype,kv_scale", POOLS,
                         ids=[f"{d}-{s}" for d, s in POOLS])
def test_pool_matches_jax_after_insert_and_decode(kv_dtype, kv_scale):
    """Insert one request cache (the same numpy values) into both pools,
    then one layer's decode write at position 0 (rope is the identity
    there, and the projections of grid values are exact): every pool
    leaf equal, the attention output within 1e-5."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(1)
    L, N, hd, d, H = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.d_model, \
        cfg.n_heads
    shape = (L, len(PLENS), BUCKET, N, hd)
    rc = {"k": (rng.standard_normal(shape) * 3).astype(np.float32),
          "v": rng.standard_normal(shape).astype(np.float32)}
    jpages = JPagedKVCache(jcfg, len(PLENS), MAX_LEN, kv_dtype=kv_dtype,
                           kv_scale=kv_scale)
    pages = PagedKVCache(cfg, len(PLENS), MAX_LEN, device="cpu",
                         kv_dtype=kv_dtype, kv_scale=kv_scale)
    for slot, n in enumerate(PLENS):
        for p in (jpages, pages):
            p.alloc(slot, n + 6)
        jpages.insert({k: jnp.asarray(v) for k, v in rc.items()}, slot,
                      row=slot)
        pages.insert({k: torch.from_numpy(v) for k, v in rc.items()}, slot,
                     row=slot)
    assert set(pages.cache) == set(jpages.cache)

    def check_leaves(when):
        # page 0 is the scratch page: bucket padding and the duplicate
        # writes into it land in an unspecified order
        for name in pages.cache:
            np.testing.assert_array_equal(
                _leaf(pages.cache[name])[:, 1:],
                _leaf(jpages.cache[name])[:, 1:], err_msg=f"{name} {when}")

    check_leaves("after insert")
    assert pages.bytes_per_token() == jpages.bytes_per_token()

    # one layer's decode write and attention, on layer 0 of the pools
    lp = {"wq": _grid(rng, (d, H, hd), 0.125),
          "wk": _grid(rng, (d, N, hd), 0.125),
          "wv": _grid(rng, (d, N, hd), 0.125),
          "wo": _grid(rng, (H, hd, d), 0.125),
          "bq": np.zeros((H, hd), np.float32),
          "bk": np.zeros((N, hd), np.float32),
          "bv": np.zeros((N, hd), np.float32)}
    x = _grid(rng, (len(PLENS), 1, d), 0.25)
    pos = np.zeros((len(PLENS), 1), np.int32)
    jspec = JSpec(backend="xla", kv_dtype=kv_dtype, kv_scale=kv_scale)
    spec = AttnSpec(backend="xla", kv_dtype=kv_dtype, kv_scale=kv_scale)
    jlayer = {k: v[0] for k, v in jpages.cache.items()}
    jy, jnew, _ = JA.attn_apply(
        jcfg, {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x),
        mode="decode", positions=jnp.asarray(pos), cache=jlayer,
        page_table=jpages.table(), attn=jspec)
    jpages.cache = {k: v.at[0].set(jnew[k])
                    for k, v in jpages.cache.items()}
    with torch.no_grad():
        y, _, _ = A.attn_apply(
            cfg, {k: torch.from_numpy(v) for k, v in lp.items()},
            torch.from_numpy(x), mode="decode",
            positions=torch.from_numpy(pos).long(),
            cache={k: v[0] for k, v in pages.cache.items()},
            page_table=pages.table(), attn=spec)
    check_leaves("after the decode write")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


# --------------------------------------------------------------- fp8 cast
def test_fp8_cast_is_nan_past_464_as_in_jax():
    """torch's cast saturates (470 -> 448); the reference's is NaN for
    |x| > 464 (464 itself ties to the even 448). The port's encode gives
    the reference's bytes on every bf16 value and on a float32 sweep."""
    assert torch.tensor(470.0).to(F8).item() == 448.0
    x = np.array([447, 448, 460, 464, 464.5, 465, 470, 480, 1e4, np.inf,
                  -464, -470, 2.0 ** -10], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = to_fp8_e4m3(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[4:10]).all() and got[3] == 448.0
    bf = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    sweep = np.concatenate([bf, np.linspace(-600, 600, 120001,
                                            dtype=np.float32)])
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        want = np.asarray(jnp.asarray(sweep, jdt).astype(jnp.float8_e4m3fn)
                          .astype(jnp.float32))
        got = to_fp8_e4m3(torch.from_numpy(sweep).to(dt)).float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(dt))


def test_fp8_pool_insert_overflow_is_nan_as_in_jax():
    """V values past 464 become NaN fp8 pages in both pools' insert."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 1, BUCKET, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = (rng.standard_normal(shape) * 300).astype(np.float32)
    assert (np.abs(v) > 464).any() and (np.abs(v) <= 448).any()
    jpages = JPagedKVCache(jcfg, 1, MAX_LEN, kv_dtype="fp8_v")
    pages = PagedKVCache(cfg, 1, MAX_LEN, device="cpu", kv_dtype="fp8_v")
    for p in (jpages, pages):
        p.alloc(0, BUCKET)
    jpages.insert({"k": jnp.asarray(k), "v": jnp.asarray(v)}, 0)
    pages.insert({"k": torch.from_numpy(k), "v": torch.from_numpy(v)}, 0)
    got = pages.cache["v_pages"][:, 1:].float().numpy()
    want = np.asarray(jpages.cache["v_pages"][:, 1:].astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any()


# ----------------------------------------------- FUM plain vs JAX kernel
def _fum_case(fmt, Sq, seed):
    B, N, G, hd, ps, nP = 2, 2, 2, 8, 4, 6
    rng = np.random.default_rng(seed)
    P = 1 + B * nP
    qq = np.round(rng.standard_normal((B, N, G, Sq, hd)) * 2 * 4096) / 4096
    table = np.arange(1, P, dtype=np.int32).reshape(B, nP)
    keep = rng.random((B, N, G, nP)) < 0.6
    fetched = keep.any(axis=(1, 2))
    q_pos = (np.asarray([nP * ps - Sq - 3, nP * ps - Sq])[:, None]
             + np.arange(Sq))[:, None, None, :]
    lists = _fetch_list(torch.from_numpy(fetched), torch.from_numpy(table),
                        torch.from_numpy(keep), torch.from_numpy(q_pos))
    if fmt == "fp8_v":
        kp = rng.integers(-127, 128, (P, ps, N, hd)).astype(np.int8)
        v8 = to_fp8_e4m3(torch.from_numpy(
            rng.standard_normal((P, ps, N, hd)).astype(np.float32) * 4))
        ks = np.full((P, N), pool_scale(4), np.float32)
        t_pools = (torch.from_numpy(kp), v8)
        j_pools = (jnp.asarray(kp), jnp.asarray(v8.float().numpy())
                   .astype(jnp.float8_e4m3fn))
        t_sc = dict(k_scale=torch.from_numpy(ks),
                    v_scale=torch.ones(P, N))
        j_sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.ones((P, N)))
    else:
        kb = torch.from_numpy(rng.standard_normal((P, ps, N, hd)).astype(
            np.float32) * 4).to(torch.bfloat16)
        vb = torch.from_numpy(rng.standard_normal((P, ps, N, hd)).astype(
            np.float32)).to(torch.bfloat16)
        t_pools = (kb, vb)
        j_pools = tuple(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                        for x in (kb, vb))
        t_sc, j_sc = dict(k_scale=None, v_scale=None), {}
    return (torch.from_numpy(qq.astype(np.float32)), t_pools, t_sc, lists,
            jnp.asarray(qq.astype(np.float32)), j_pools, j_sc)


@pytest.mark.parametrize("fmt", ["fp8_v", "bf16"])
@pytest.mark.parametrize("Sq", [1, 3])
def test_fum_plain_matches_jax_kernel(fmt, Sq):
    tq, tp, tsc, lists, jq, jp, jsc = _fum_case(fmt, Sq, seed=Sq + 4)
    got = hdp_paged_fum_decode_ref(tq, *tp, *lists, **tsc)
    want = j_fum(jq, *jp, *(jnp.asarray(x.numpy()) for x in lists),
                 interpret=True, **jsc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ------------------------------------------------ page-chunk stage 3
def _pool_case(fmt, seed=0):
    B, N, G, hd, ps, nP = 2, 2, 2, 8, 4, 5
    P = 1 + B * nP
    rng = np.random.default_rng(seed)
    kw = dict(block_q=1, block_k=ps, rho_b=0.5, tau_h=0.0, calib="none",
              causal=True, normalize_head_score=True)
    k = (rng.standard_normal((P, ps, N, hd)) * 3).astype(np.float32)
    v = rng.standard_normal((P, ps, N, hd)).astype(np.float32)
    q = (rng.standard_normal((B, N, G, 1, hd)) * 2).astype(np.float32)
    table = np.arange(1, P, dtype=np.int32).reshape(B, nP)
    table[1, -1] = 0                                  # one unallocated page
    pos = np.asarray([[nP * ps - 2], [(nP - 1) * ps - 3]], np.int32)
    ar = np.arange(nP * ps)
    k_pos = np.where(ar[None] <= pos, ar, -1)[:, None, None, :]
    s = np.full((P, N), pool_scale(4), np.float32)
    if fmt == "fp32":
        pools = dict(k=k, v=v, ik=np.asarray(scout_int8(
            torch.from_numpy(k), HDPConfig(**kw))), ks=None, vs=None)
    else:
        kc = np.clip(np.round(k / s[:, None, :, None]), -127, 127).astype(
            np.int8)
        vc = np.clip(np.round(v / s[:, None, :, None]), -127, 127).astype(
            np.int8)
        pools = dict(k=kc, v=vc, ik=None, ks=s, vs=s.copy())
        if fmt == "fp8_v":
            pools.update(v=v, vs=np.ones_like(s))
    return q, pools, table, pos[:, None, None, :], k_pos, kw


@pytest.mark.parametrize("fmt", ["int8", "fp8_v", "fp32"])
@pytest.mark.parametrize("pages_per_chunk", [1, 2])
def test_paged_scan_attention_matches_jax(fmt, pages_per_chunk):
    q, pools, table, q_pos, k_pos, kw = _pool_case(fmt)
    ps = kw["block_k"]

    def tp(x, fp8=False):
        if x is None:
            return None
        t = torch.from_numpy(x)
        return to_fp8_e4m3(t) if fp8 else t

    def jp(x, fp8=False):
        if x is None:
            return None
        return jnp.asarray(x).astype(jnp.float8_e4m3fn) if fp8 \
            else jnp.asarray(x)

    fp8 = fmt == "fp8_v"
    out, st = hdp_paged_decode_attention(
        tp(q), tp(pools["k"]), tp(pools["v"], fp8), tp(pools["ik"]),
        tp(table), q_pos=tp(q_pos), k_pos=tp(k_pos), hdp=HDPConfig(**kw),
        stage3="xla", page_chunk=pages_per_chunk * ps,
        k_scale=tp(pools["ks"]), v_scale=tp(pools["vs"]), return_stats=True)
    jout, jst = j_paged_attention(
        jp(q), jp(pools["k"]), jp(pools["v"], fp8), jp(pools["ik"]),
        jp(table), q_pos=jp(q_pos), k_pos=jp(k_pos), hdp=JHDPConfig(**kw),
        stage3="xla", page_chunk=pages_per_chunk * ps,
        k_scale=jp(pools["ks"]), v_scale=jp(pools["vs"]), return_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    assert set(st) == set(jst)
    for name in st:
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(jst[name]),
                                      err_msg=name)
    assert 0 < float(st["page_sparsity"].max()) < 1
