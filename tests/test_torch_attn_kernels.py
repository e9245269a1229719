"""Port parity of the block-sparse FUM attention and flash kernels
(the scout and the pipeline are in ``test_torch_kernels.py``).

The same numpy inputs, drawn from a seed, go through the JAX kernels in
interpret mode (as ``tests/test_kernels.py`` runs them) and through the
port's wrappers on CPU tensors, which run the plain versions written
from the Pallas bodies. Tolerances: outputs within 1e-4 in fp32 (the
sum order differs) and 2e-2 with bf16 operands (p is rounded to bf16
before P.V in both)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_fixed as jquantize_fixed
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.hdp_block_attn import \
    hdp_block_sparse_attention as jblock
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TOL = 1e-4
TOL_BF16 = 2e-2


def rnd(*shape, seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def both(x, dtype=None):
    """(jax array, torch tensor) of one numpy array, optionally cast."""
    j, t = jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- block attn
def _block_inputs(B=1, H=2, S=256, hd=64, seed=0):
    q = np.asarray(jquantize_fixed(jnp.asarray(rnd(B, H, S, hd, seed=seed))))
    k = np.asarray(jquantize_fixed(jnp.asarray(rnd(B, H, S, hd,
                                                   seed=seed + 1))))
    v = rnd(B, H, S, hd, seed=seed + 2)
    return q, k, v


def _lists(keep, theta, max_keep):
    jidx, jcnt = jref.keep_mask_to_indices(jnp.asarray(keep),
                                           jnp.asarray(theta), max_keep)
    return (jidx, jcnt), (torch.from_numpy(np.array(jidx)),
                          torch.from_numpy(np.array(jcnt)))


class TestBlockAttnKernel:
    @pytest.mark.parametrize("causal,approx", [(True, True), (False, False)])
    def test_full_keep_matches_jax(self, causal, approx):
        q, k, v = _block_inputs(seed=11)
        nq = nk = 256 // 64
        keep = np.ones((1, 2, nq, nk), bool)
        (jidx, jcnt), (tidx, tcnt) = _lists(
            keep, np.ones(keep.shape, np.float32), nk)
        hk = np.ones((1, 2), bool)
        want = jblock(*(jnp.asarray(x) for x in (q, k, v)), jidx, jcnt,
                      jnp.asarray(hk), causal=causal, approx=approx,
                      block_q=64, block_k=64, interpret=True)
        got = hdp_block_sparse_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), tidx, tcnt,
            torch.from_numpy(hk), causal=causal, approx=approx,
            block_q=64, block_k=64)
        close(got, want, TOL)
        # ... and the oracles agree
        close(ref.hdp_block_attn_ref(
            *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(keep),
            block_q=64, block_k=64, causal=causal, approx=approx),
            jref.hdp_block_attn_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                    jnp.asarray(keep), block_q=64, block_k=64,
                                    causal=causal, approx=approx), TOL)

    @pytest.mark.parametrize("S,bq,bk,v_dtype", [
        (256, 64, 64, None), (256, 64, 64, "bf16"), (10, 2, 2, None),
        (100, 32, 16, "bf16")])
    def test_sparse_keep_matches_jax(self, S, bq, bk, v_dtype):
        q, k, v = _block_inputs(S=S, seed=13)
        if S % bq or S % bk:      # ragged S: keep a seeded half of blocks
            nq, nk = -(-S // bq), -(-S // bk)
            keep = np.random.default_rng(1).random((1, 2, nq, nk)) < 0.5
            keep[..., 0] = True
            theta = np.ones(keep.shape, np.float32)
        else:                     # the scout's keep
            theta, keep, _ = jref.hdp_scout_ref(
                jnp.trunc(jnp.asarray(q)), jnp.trunc(jnp.asarray(k)),
                block_q=bq, block_k=bk, rho_b=0.5, causal=True)
        keep, theta = np.asarray(keep), np.asarray(theta)
        (jidx, jcnt), (tidx, tcnt) = _lists(keep, theta, keep.shape[-1])
        hk = np.ones((1, 2), bool)
        jv, tv = both(v, v_dtype)
        want = jblock(jnp.asarray(q), jnp.asarray(k), jv, jidx, jcnt,
                      jnp.asarray(hk), causal=True, approx=True, block_q=bq,
                      block_k=bk, interpret=True)
        got = hdp_block_sparse_attention(
            torch.from_numpy(q), torch.from_numpy(k), tv, tidx, tcnt,
            torch.from_numpy(hk), causal=True, approx=True, block_q=bq,
            block_k=bk)
        assert got.dtype == torch.float32
        close(got, want, TOL_BF16 if v_dtype else TOL)

    def test_decode_route_kv_len_and_scale(self):
        """The paged decode route's call: one query row in an 8-row tile,
        non-causal, per-row kv_len, and a score rescale."""
        B, H, hd, bk = 2, 3, 16, 4
        q = np.asarray(jquantize_fixed(jnp.asarray(rnd(B, H, 1, hd, seed=3))))
        k = np.asarray(jquantize_fixed(jnp.asarray(rnd(B, H, 24, hd, seed=4))))
        v = rnd(B, H, 24, hd, seed=5)
        keep = np.random.default_rng(2).random((B, H, 1, 6)) < 0.6
        keep[..., 0] = True
        theta = np.random.default_rng(3).random(keep.shape).astype(np.float32)
        (jidx, jcnt), (tidx, tcnt) = _lists(keep, theta, 6)
        hk = np.array([[True, False, True], [True, True, True]])
        lens = np.array([[13, 13, 13], [24, 24, 24]], np.int32)
        want = jblock(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jidx,
                      jcnt, jnp.asarray(hk), causal=False, approx=True,
                      block_q=8, block_k=bk, score_scale=0.5,
                      kv_len=jnp.asarray(lens), interpret=True)
        got = hdp_block_sparse_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tidx, tcnt, torch.from_numpy(hk), causal=False, approx=True,
            block_q=8, block_k=bk, score_scale=torch.tensor(0.5),
            kv_len=torch.from_numpy(lens))
        close(got, want, TOL)
        assert float(got[0, 1].abs().max()) == 0.0

    def test_head_gate_zeroes_output(self):
        q, k, v = _block_inputs(seed=17)
        nq = nk = 256 // 64
        keep = np.ones((1, 2, nq, nk), bool)
        _, (tidx, tcnt) = _lists(keep, np.ones(keep.shape, np.float32), nk)
        out = hdp_block_sparse_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), tidx, tcnt,
            torch.tensor([[True, False]]), causal=True, block_q=64,
            block_k=64)
        assert float(out[0, 1].abs().max()) == 0.0
        assert float(out[0, 0].abs().max()) > 0.0


# ------------------------------------------------------------------ flash
class TestFlashKernel:
    @pytest.mark.parametrize("shape,blocks", [
        ((1, 2, 128, 64), (64, 64)),
        ((1, 1, 160, 64), (64, 64)),       # ragged S
        ((1, 2, 10, 8), (2, 2)),
    ])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax(self, shape, blocks, causal):
        q, k, v = (rnd(*shape, seed=s) for s in (1, 2, 3))
        bq, bk = blocks
        want = jflash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                      block_q=bq, block_k=bk, interpret=True)
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, block_q=bq, block_k=bk)
        close(got, want, TOL)
        close(ref.flash_attention_ref(*(torch.from_numpy(x)
                                        for x in (q, k, v)), causal=causal),
              jref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                       causal=causal), TOL)

    @pytest.mark.parametrize("dtype", [None, "bf16"])
    def test_dtypes(self, dtype):
        qkv = [both(rnd(1, 2, 128, 64, seed=s), dtype) for s in (4, 5, 6)]
        want = jflash(*(j for j, _ in qkv), causal=True, interpret=True)
        got = flash_attention(*(t for _, t in qkv), causal=True)
        assert got.dtype == qkv[0][1].dtype
        close(got, want, TOL_BF16 if dtype else TOL)
