"""Port parity of the integer scout kernel, the keep-mask-to-list step
and the full-sequence HDP pipeline (``kernels/ops.hdp_attention_tpu``);
the block-sparse and flash kernels are in ``test_torch_attn_kernels.py``.

The same numpy inputs, drawn from a seed, go through the JAX kernels in
interpret mode (as ``tests/test_kernels.py`` runs them) and through the
port's wrappers on CPU tensors, which run the plain versions written
from the Pallas bodies. Tolerances: theta within rtol 1e-5 and keep
masks exactly equal (integer sums, exact at these sizes); attention
outputs within 1e-4 in fp32 (the sum order differs) and 2e-2 with bf16
operands (p is rounded to bf16 before P.V in both)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HDPConfig as JHDPConfig
from repro.kernels import ref as jref
from repro.kernels.hdp_scout import hdp_scout as jscout
from repro.kernels.ops import hdp_attention_tpu as jpipeline
from repro_torch.core.config import HDPConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hdp_scout import hdp_scout

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


# ------------------------------------------------------------------ scout
class TestScoutKernel:
    @pytest.mark.parametrize("shape,blocks", [
        ((1, 2, 128, 64), (64, 64)),
        ((1, 2, 10, 8), (2, 2)),          # the reduced config's 2x2 blocks
        ((1, 1, 100, 16), (32, 16)),      # ragged S
    ])
    @pytest.mark.parametrize("rho,causal", [(0.5, True), (-0.5, False),
                                            (-0.5, True)])
    def test_matches_jax_kernel(self, shape, blocks, rho, causal):
        iq = np.trunc(rnd(*shape, seed=7, scale=3.0))
        ik = np.trunc(rnd(*shape, seed=8, scale=3.0))
        (jiq, tiq), (jik, tik) = both(iq), both(ik)
        bq, bk = blocks
        want = jscout(jiq, jik, rho_b=rho, block_q=bq, block_k=bk,
                      causal=causal, interpret=True)
        got = hdp_scout(tiq, tik, rho_b=rho, block_q=bq, block_k=bk,
                        causal=causal)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5)

    @pytest.mark.parametrize("rho,causal", [(0.5, True), (-0.5, False)])
    def test_oracle_matches_jax_oracle(self, rho, causal):
        iq = np.trunc(rnd(1, 2, 128, 64, seed=9, scale=3.0))
        ik = np.trunc(rnd(1, 2, 128, 64, seed=10, scale=3.0))
        (jiq, tiq), (jik, tik) = both(iq), both(ik)
        want = jref.hdp_scout_ref(jiq, jik, block_q=64, block_k=64,
                                  rho_b=rho, causal=causal)
        got = ref.hdp_scout_ref(tiq, tik, block_q=64, block_k=64,
                                rho_b=rho, causal=causal)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5)

    @pytest.mark.parametrize("chunk", [1, 3, 4])
    def test_any_chunk_equals_jax(self, chunk):
        iq = np.trunc(rnd(1, 1, 256, 64, seed=9, scale=3.0))
        ik = np.trunc(rnd(1, 1, 256, 64, seed=10, scale=3.0))
        (jiq, tiq), (jik, tik) = both(iq), both(ik)
        want = jscout(jiq, jik, rho_b=0.5, block_q=64, block_k=64,
                      chunk_blocks=1, interpret=True)
        got = hdp_scout(tiq, tik, rho_b=0.5, block_q=64, block_k=64,
                        chunk_blocks=chunk)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6)


# ----------------------------------------------------- keep -> index lists
@pytest.mark.parametrize("max_keep,ties", [(4, False), (2, True), (1, True)])
def test_keep_mask_to_indices_equal(max_keep, ties):
    rng = np.random.default_rng(5)
    keep = rng.random((2, 3, 4, 4)) < 0.6
    theta = rng.integers(0, 3, (2, 3, 4, 4)).astype(np.float32) if ties \
        else rng.random((2, 3, 4, 4)).astype(np.float32)
    want = jref.keep_mask_to_indices(jnp.asarray(keep), jnp.asarray(theta),
                                     max_keep)
    got = ref.keep_mask_to_indices(torch.from_numpy(keep),
                                   torch.from_numpy(theta), max_keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------- end-to-end pipeline
class TestHDPPipeline:
    @pytest.mark.parametrize("calib,v_dtype", [("max", None), ("none", None),
                                                ("max", "bf16")])
    def test_pipeline_matches_jax(self, calib, v_dtype):
        B, H, S, hd = 1, 2, 256, 64
        q, k, v = (rnd(B, H, S, hd, seed=s) for s in (19, 20, 21))
        kw = dict(block_q=64, block_k=64, rho_b=0.5, tau_h=0.0,
                  causal=True, normalize_head_score=True, calib=calib)
        jv, tv = both(v, v_dtype)
        out_j, st_j = jpipeline(jnp.asarray(q), jnp.asarray(k), jv,
                                JHDPConfig(**kw), interpret=True,
                                return_stats=True)
        out_t, st_t = ops.hdp_attention_tpu(
            torch.from_numpy(q), torch.from_numpy(k), tv, HDPConfig(**kw),
            return_stats=True)
        close(out_t, out_j, TOL_BF16 if v_dtype else TOL)
        for name in ("block_sparsity", "head_sparsity",
                     "kept_blocks_per_row", "theta_head"):
            np.testing.assert_allclose(np.asarray(st_t[name]),
                                       np.asarray(st_j[name]), rtol=1e-6,
                                       err_msg=name)
        assert st_t["total_blocks"] == st_j["total_blocks"]

    def test_max_keep_cap_finite_and_equal(self):
        B, H, S, hd = 1, 2, 256, 64
        q, k, v = (rnd(B, H, S, hd, seed=s) for s in (22, 23, 24))
        kw = dict(block_q=64, block_k=64, rho_b=0.5, causal=True,
                  normalize_head_score=True)
        exact, _ = ops.hdp_attention_tpu(
            *(torch.from_numpy(x) for x in (q, k, v)), HDPConfig(**kw))
        capped, _ = ops.hdp_attention_tpu(
            *(torch.from_numpy(x) for x in (q, k, v)), HDPConfig(**kw),
            max_keep=2)
        want, _ = jpipeline(*(jnp.asarray(x) for x in (q, k, v)),
                            JHDPConfig(**kw), max_keep=2, interpret=True)
        assert bool(torch.isfinite(capped).all())
        close(capped, want, TOL)
        cos = float((exact * capped).sum()
                    / (exact.norm() * capped.norm() + 1e-9))
        assert cos > 0.8
