"""The integer scout's tensor-core path, on the CPU.

On the card the scout takes one of two kernels, picked by
``scout_path`` from the shapes alone: int8 tensor-core products (wgmma
s8) for hd a multiple of 32 up to 128 or 112 (zamba2-7b's, on copies
zero-padded to 128 columns: ``tests/test_torch_scout_tc_hd112.py``) with
64- or 128-row blocks, and ``__dp4a`` for the rest. The tensor-core
kernel's arithmetic is written out here in numpy: int8 operands, exact
int32 scores, each thread's int32 sum of the |s| it holds in the wgmma
accumulator layout, int64 block sums, one rounding to fp32, then the
Sparsity Engine in fp32. It
must equal the plain version (``ref.hdp_scout_plain``) and the JAX
kernel in interpret mode bit for bit: theta, keep and theta_head. The
inputs keep every block sum below 2^24, where the reference's fp32 sums
are exact too; values at -128 and 127 whose sums pass 2^24 are held
against the plain version only. The kernels themselves run only on the
card (``chip_smoke.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hdp_scout import hdp_scout as jscout
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.hdp_scout import PATHS, hdp_scout, scout_path
from repro_torch.kernels.ref import hdp_scout_plain

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

F32 = np.float32


def tc_emulation(iq, ik, *, rho_b, block_q, block_k, causal):
    """The tensor-core kernel's arithmetic on numpy integer parts [B,H,S,hd]
    -> (theta, keep, theta_head)."""
    B, H, Sq, hd = iq.shape
    Sk = ik.shape[2]
    bq, bk = block_q, block_k
    assert bq % 64 == 0 and bk % 8 == 0
    for x in (iq, ik):   # the int8 operands (a bad value is the kernel's NaN)
        assert np.all((x == np.trunc(x)) & (x >= -128) & (x <= 127))
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    q8 = np.zeros((B, H, nq * bq, hd), np.int64)
    k8 = np.zeros((B, H, nk * bk, hd), np.int64)
    q8[:, :, :Sq], k8[:, :, :Sk] = iq, ik          # zero rows pad the blocks
    theta64 = np.zeros((B, H, nq, nk), np.int64)
    bvalid = np.zeros((nq, nk), bool)
    for i in range(nq):
        rows = i * bq + np.arange(bq)
        for j in range(nk):
            if causal and j * bk > i * bq + bq - 1:
                continue                           # not walked: theta 0
            bvalid[i, j] = True
            cols = j * bk + np.arange(bk)
            s = q8[:, :, rows] @ np.swapaxes(k8[:, :, cols], -1, -2)
            assert np.abs(s).max() < 2 ** 31        # exact in int32
            a = np.abs(s)
            if causal:
                a = np.where(rows[:, None] >= cols[None, :], a, 0)
            # accumulator (n, e) of warp w's lane (g, t) in warpgroup wg:
            # row 64 wg + 16 w + 8 (e >> 1) + g, column 8 n + 2 t + (e & 1)
            a = a.reshape(B, H, bq // 64, 4, 2, 8, bk // 8, 4, 2)
            per_thread = a.sum(axis=(4, 6, 8))
            assert per_thread.max() < 2 ** 31       # int32 per thread
            theta64[:, :, i, j] = per_thread.astype(np.int32).astype(
                np.int64).sum(axis=(2, 3, 4, 5))
    theta = theta64.astype(F32)                     # one rounding
    if rho_b >= 0:
        c_ext, c_mean = F32(rho_b), F32(1.0 - rho_b)
    else:
        c_ext, c_mean = F32(-rho_b), F32(1.0 + rho_b)
    cnt = np.maximum(bvalid.sum(-1), 1).astype(F32)
    tsum = np.where(bvalid, theta, 0).astype(np.float64).sum(-1).astype(F32)
    mean = tsum / cnt
    if rho_b >= 0:
        ext = np.where(bvalid, theta, F32(-1e30)).max(-1)
    else:
        ext = np.where(bvalid, theta, F32(1e30)).min(-1)
    thr = (ext * c_ext).astype(F32) + (mean * c_mean).astype(F32)
    keep = (theta >= thr[..., None]) & bvalid
    theta_head = theta64.sum((-2, -1)).astype(F32)
    return theta, keep, theta_head


def small_ints(shape, seed):
    """Integer parts of N(0, 2), with one q or k row per head at the int8
    extremes -128 and 127: pairs of them reach |s| = 128 * 128 * hd."""
    rng = np.random.default_rng(seed)
    x = np.trunc(rng.normal(0, 2, shape)).astype(F32)
    ext = np.where(rng.random(shape[-1]) < 0.5, -128.0, 127.0).astype(F32)
    x[:, :, 5 % shape[2]] = ext
    return x


def assert_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("S", [384, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rho", [0.5, -0.5])
def test_emulation_equals_plain_and_jax_bit_for_bit(S, causal, rho):
    shape = (1, 2, S, 128)
    iq, ik = small_ints(shape, 1), small_ints(shape, 2)
    kw = dict(rho_b=rho, block_q=128, block_k=128, causal=causal)
    emu = tc_emulation(iq, ik, **kw)
    assert emu[0].max() < 2 ** 24 and emu[2].max() < 2 ** 24
    plain = hdp_scout_plain(torch.from_numpy(iq), torch.from_numpy(ik), **kw)
    ref = jscout(jnp.asarray(iq), jnp.asarray(ik), interpret=True, **kw)
    assert_equal(plain, emu)
    assert_equal(ref, emu)
    assert emu[1].any() and not emu[1].all()


@pytest.mark.parametrize("causal", [True, False])
def test_emulation_equals_plain_at_the_int8_extremes(causal):
    """All values at -128 or 127: |s| up to 2^21, block sums past 2^31,
    exact in the kernel's integers and the plain version's float64."""
    rng = np.random.default_rng(3)
    iq, ik = (np.where(rng.random((1, 1, 300, 128)) < 0.5, -128.0,
                       127.0).astype(F32) for _ in range(2))
    ik[:, :, ::3] = -128.0
    kw = dict(rho_b=0.5, block_q=128, block_k=128, causal=causal)
    emu = tc_emulation(iq, ik, **kw)
    assert emu[0].max() > 2 ** 31
    assert_equal(hdp_scout_plain(torch.from_numpy(iq), torch.from_numpy(ik),
                                 **kw), emu)


@pytest.mark.parametrize("hd,bq,bk,causal", [
    (128, 64, 128, True), (128, 128, 64, False), (64, 64, 64, True),
    (96, 64, 128, True), (32, 128, 64, False)])
def test_emulation_equals_plain_on_the_other_tensor_core_shapes(hd, bq, bk,
                                                                causal):
    shape = (1, 2, 250, hd)
    iq, ik = small_ints(shape, 4), small_ints(shape, 5)
    kw = dict(rho_b=-0.5, block_q=bq, block_k=bk, causal=causal)
    assert scout_path(hd, bq, bk) == "tensor_core"
    assert_equal(hdp_scout_plain(torch.from_numpy(iq), torch.from_numpy(ik),
                                 **kw), tc_emulation(iq, ik, **kw))


def test_scout_path_of_the_configs():
    cfg = get_config("qwen2-1.5b")
    small = reduced(cfg)
    # the aligned prefill of qwen2-1.5b: hd 128, 128x128 blocks
    assert scout_path(cfg.hd, cfg.hdp.block_q, cfg.hdp.block_k) \
        == "tensor_core"
    # the reduced configs: hd 16, 2x2 blocks
    assert scout_path(small.hd, small.hdp.block_q, small.hdp.block_k) \
        == "dp4a"
    # the aligned prefill of zamba2-7b: hd 112, 128x128 blocks, on int8
    # copies zero-padded to 128 columns
    z = get_config("zamba2-7b")
    assert scout_path(z.hd, z.hdp.block_q, z.hdp.block_k) == "tensor_core"


@pytest.mark.parametrize("hd,bq,bk,want", [
    (128, 128, 128, "tensor_core"), (64, 64, 64, "tensor_core"),
    (96, 64, 128, "tensor_core"), (32, 128, 64, "tensor_core"),
    (16, 2, 2, "dp4a"), (8, 2, 2, "dp4a"), (64, 32, 16, "dp4a"),
    (128, 128, 32, "dp4a"), (160, 128, 128, "dp4a"), (256, 64, 64, "dp4a"),
    (130, 128, 128, None), (512, 64, 64, None), (128, 256, 128, None),
    (16, 128, 0, None),
    (112, 128, 128, "tensor_core"), (112, 64, 128, "tensor_core"),
    (112, 128, 64, "tensor_core"), (112, 64, 64, "tensor_core"),
    (112, 32, 32, "dp4a"), (112, 2, 2, "dp4a"), (80, 128, 128, "dp4a"),
    (144, 64, 64, "dp4a"), (112, 256, 128, None)])
def test_scout_path_choice(hd, bq, bk, want):
    if want is None:
        with pytest.raises(ValueError):
            scout_path(hd, bq, bk)
    else:
        assert scout_path(hd, bq, bk) == want


def test_cpu_calls_count_no_launch():
    shape = (1, 2, 256, 128)
    iq = torch.from_numpy(small_ints(shape, 6))
    ik = torch.from_numpy(small_ints(shape, 7))
    kw = dict(rho_b=0.5, block_q=128, block_k=128, causal=True)
    before = dict(hdp_scout.launches_by_path)
    n = hdp_scout.launches
    want = hdp_scout_plain(iq, ik, **kw)
    for path in (None,) + PATHS:
        assert_equal(hdp_scout(iq, ik, path=path, **kw), want)
    assert hdp_scout.launches == n
    assert hdp_scout.launches_by_path == before
    with pytest.raises(ValueError, match="path"):
        hdp_scout(iq, ik, path="mma", **kw)
