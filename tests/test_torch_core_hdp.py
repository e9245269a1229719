"""Port parity of the rest of ``core/``: ``repro_torch.core`` (blocking,
hdp, topk) against ``repro.core``, and the paper's polynomial softmax
routed through the model as the reference routes it.

The port of ``tests/test_core_hdp.py``: each of its tests runs on the
port with the reference's own assertions, and every function is also
held against its JAX counterpart on the same inputs (numpy, from a
seed): keep masks, ``topk_block_mask`` and ``net_sparsity`` exactly;
``poly_exp``, ``linear_reciprocal`` and ``approx_softmax`` within
atol 1e-6; ``hdp_attention`` and ``hdp_attention_reference`` outputs
within atol 1e-5. The JAX functions run compiled (``jax.jit``), as the
reference engine runs them: XLA compiles a division by a constant into
a product with its reciprocal, and the port follows the compiled
reference.

Then ``approx_softmax=True`` on reduced qwen2-1.5b: the HDP prefill's
logits within 1e-4 of JAX's and greedy tokens equal to the JAX engine's,
and the registry resolving such calls to the same backend in both
packages (the kernel backends decline the flag, so decode runs the plain
paged stage 3, whose softmax is the exact one in both).
"""
from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro_torch.attention import AttnSpec as TSpec
from repro.attention import resolve_backend as jresolve
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import blocking as jblocking
from repro.core import hdp as jhdp
from repro.core import quant as jquant
from repro.core import topk as jtopk
from repro.core.config import HDPConfig as JHDPConfig
from repro.models import registry as jregistry
from repro.models.attention import build_attn_call as jbuild
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import resolve_backend
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import (HDPConfig, dense_attention_reference,
                              hdp_attention, hdp_attention_reference,
                              int_frac_split, mask_agreement, quantize_fixed,
                              topk_attention, topk_block_mask)
from repro_torch.core import blocking
from repro_torch.core.quant import quantize_and_split
from repro_torch.models import registry
from repro_torch.models.attention import build_attn_call
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TOL_SOFTMAX = 1e-6
TOL_ATTN = 1e-5


def rnd(*shape, seed=0, scale=2.0):
    g = np.random.default_rng(seed)
    return (scale * g.standard_normal(shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jcfg(cfg: HDPConfig) -> JHDPConfig:
    return JHDPConfig(**cfg.__dict__)


def _hdp_both(fn, jfn, q, k, v, cfg, **kw):
    """The port's and the compiled reference's (out, stats) on one input
    (the reference's stats as a namespace of its HDPStats fields)."""
    out, st = fn(_t(q), _t(k), _t(v), cfg, **kw)

    def ref(q, k, v):
        o, s = jfn(q, k, v, _jcfg(cfg), **kw)
        return o, (None if s is None else dataclasses.asdict(s))

    jout, jst = jax.jit(ref)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, st, jout, (None if jst is None
                           else types.SimpleNamespace(**jst))


def _same_stats(st, jst):
    """Keep masks, head gates and the integer scout's block importances
    exact; the row thresholds (rho times a max plus a mean: XLA folds
    the constants in its own order) to an ulp."""
    _eq(st.keep_blocks.numpy(), jst.keep_blocks)
    _eq(st.head_kept.numpy(), jst.head_kept)
    _eq(st.theta.numpy(), jst.theta)
    np.testing.assert_allclose(st.threshold.numpy(), jst.threshold,
                               rtol=1e-6)
    # the fractions within an ulp: XLA turns a division by a count that
    # is a compile-time constant into a product with its reciprocal
    # (``test_mask_agreement_and_net_sparsity_exact`` holds the function
    # itself exact against the reference as its tests call it)
    for f in ("block_sparsity", "head_sparsity", "net_sparsity"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   getattr(jst, f), rtol=2e-7, atol=0)


# ---------------------------------------------------------------- quantizer
class TestQuant:
    def test_grid_and_range(self):
        x = rnd(64, 32, seed=1, scale=40.0)
        q = quantize_fixed(_t(x), int_bits=4, frac_bits=12)
        assert float(q.max()) <= 16.0 - 2**-12 + 1e-9
        assert float(q.min()) >= -16.0
        scaled = q.numpy().astype(np.float64) * 2**12
        np.testing.assert_allclose(scaled, np.round(scaled), atol=1e-6)
        _eq(q.numpy(), jquant.quantize_fixed(jnp.asarray(x), 4, 12))

    def test_split_identity_and_range(self):
        x = quantize_fixed(_t(rnd(128, seed=2, scale=5.0)))
        i, f = int_frac_split(x)
        np.testing.assert_allclose((i + f).numpy(), x.numpy(), rtol=0,
                                   atol=1e-6)
        assert np.all(i.numpy() == np.trunc(i.numpy()))
        assert np.all(np.abs(f.numpy()) < 1.0)
        ji, jf = jquant.int_frac_split(jnp.asarray(x.numpy()))
        _eq(i.numpy(), ji)
        _eq(f.numpy(), jf)

    def test_near_zero_has_zero_integer(self):
        x = np.linspace(-0.999, 0.999, 101).astype(np.float32)
        i, _ = int_frac_split(_t(x))
        assert np.all(i.numpy() == 0.0)


# ------------------------------------------------------------- block algebra
class TestBlocking:
    def test_block_abs_sum_matches_loop(self):
        x = rnd(8, 12, seed=3)
        theta = blocking.block_abs_sum(_t(x), 2, 2)
        ref = np.zeros((4, 6))
        xn = np.abs(x)
        for i in range(4):
            for j in range(6):
                ref[i, j] = xn[2 * i: 2 * i + 2, 2 * j: 2 * j + 2].sum()
        np.testing.assert_allclose(theta.numpy(), ref, rtol=1e-6)
        _close(blocking.block_sum(_t(x), 2, 2),
               jblocking.block_sum(jnp.asarray(x), 2, 2), 1e-6)

    @pytest.mark.parametrize("rho", [0.0, 0.3, 0.9, -0.3, -0.9])
    def test_row_threshold_both_branches(self, rho):
        theta = np.abs(rnd(5, 8, seed=4))
        th = blocking.row_threshold(_t(theta), rho)
        t = theta
        if rho >= 0:
            expect = rho * t.max(-1) + (1 - rho) * t.mean(-1)
        else:
            expect = -rho * t.min(-1) + (1 + rho) * t.mean(-1)
        np.testing.assert_allclose(th.numpy()[..., 0], expect, rtol=1e-5)
        np.testing.assert_allclose(th.numpy(), jax.jit(functools.partial(
            jblocking.row_threshold, rho_b=rho))(jnp.asarray(theta)),
            rtol=1e-6)

    def test_max_block_always_survives(self):
        # Theta <= max for rho in [0, 1): at least one block kept per row
        for seed in range(5):
            theta = _t(np.abs(rnd(7, 9, seed=seed)))
            th = blocking.row_threshold(theta, 0.95)
            keep = blocking.block_keep_mask(theta, th)
            assert bool(keep.any(dim=-1).all())

    def test_expand_mask(self):
        m = torch.tensor([[True, False], [False, True]])
        e = blocking.expand_block_mask(m, 2, 3)
        assert e.shape == (4, 6)
        assert bool(e[0, 0]) and not bool(e[0, 3]) and bool(e[2, 3])

    @pytest.mark.parametrize("off", [0, 5])
    def test_causal_block_valid_exact(self, off):
        _eq(blocking.causal_block_valid(16, 24, 4, 2, q_offset=off).numpy(),
            jblocking.causal_block_valid(16, 24, 4, 2, q_offset=off))
        keep = np.arange(8)[None, :] < 4
        s = rnd(3, 8, seed=5)
        _eq(blocking.apply_score_mask(_t(s), _t(keep)).numpy(),
            jblocking.apply_score_mask(jnp.asarray(s), jnp.asarray(keep)))

    def test_poly_softmax_close_to_exact(self):
        s = rnd(4, 64, seed=6, scale=3.0)
        exact = torch.softmax(_t(s), dim=-1)
        approx = blocking.approx_softmax(_t(s))
        assert float((exact - approx).abs().max()) < 0.02
        _close(approx, jax.jit(jblocking.approx_softmax)(jnp.asarray(s)),
               TOL_SOFTMAX)

    def test_masked_softmax_exclusion(self):
        s = rnd(3, 8, seed=7)
        keep = np.arange(8)[None, :] < 4
        p = blocking.masked_softmax(_t(s), _t(keep))
        np.testing.assert_allclose(p[:, 4:].numpy(), 0.0)
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)
        pa = blocking.approx_softmax(_t(s), _t(np.broadcast_to(keep, s.shape)))
        np.testing.assert_allclose(pa[:, 4:].numpy(), 0.0)
        _close(pa, jax.jit(jblocking.approx_softmax)(
            jnp.asarray(s), jnp.asarray(np.broadcast_to(keep, s.shape))),
            TOL_SOFTMAX)


class TestPolySoftmaxParity:
    """The HDP softmax unit against the compiled reference, on the
    inputs where the two could part: -x/ln2 at and one ulp around the
    integers (range reduction) and sums at and one ulp around powers of
    two (the reciprocal's exponent)."""

    def test_poly_exp(self):
        k = np.arange(0, 60, dtype=np.float32)
        edge = -(k * np.float32(np.log(2.0)))
        x = np.concatenate([edge, np.nextafter(edge, np.float32(0)),
                            np.nextafter(edge, np.float32(-np.inf)),
                            rnd(4096, seed=40, scale=12.0), [0.0, 3.0]]
                           ).astype(np.float32)
        got = blocking.poly_exp(_t(x))
        _close(got, jax.jit(jblocking.poly_exp)(jnp.asarray(x)), TOL_SOFTMAX)
        # within the reference's own error bound of exp
        ref = np.exp(np.minimum(x, 0.0))
        assert np.all(np.abs(got.numpy() - ref) <= 0.04 * ref + 1e-6)

    def test_linear_reciprocal(self):
        p2 = (2.0 ** np.arange(-20, 40)).astype(np.float32)
        s = np.concatenate([p2, np.nextafter(p2, np.float32(0)),
                            np.nextafter(p2, np.float32(np.inf)),
                            np.abs(rnd(4096, seed=41, scale=50.0)) + 1e-3,
                            [0.0, 1e-35]]).astype(np.float32)
        got = blocking.linear_reciprocal(_t(s)).numpy()
        want = np.asarray(jax.jit(jblocking.linear_reciprocal)(
            jnp.asarray(s)))
        # relative: the reciprocals span 2^-40..2^20
        np.testing.assert_allclose(got, want, rtol=TOL_SOFTMAX, atol=0)
        big = s >= 1.0
        _close(got[big], want[big], TOL_SOFTMAX)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_approx_softmax_masked(self, seed):
        s = rnd(6, 40, seed=50 + seed, scale=4.0)
        keep = np.random.default_rng(seed).random((6, 40)) < 0.6
        keep[0] = False                    # a fully pruned row gives zeros
        got = blocking.approx_softmax(_t(s), _t(keep))
        _close(got, jax.jit(jblocking.approx_softmax)(
            jnp.asarray(s), jnp.asarray(keep)), TOL_SOFTMAX)
        assert float(got[0].abs().max()) == 0.0


# --------------------------------------------------------------- Algorithm 2
class TestHDPAttention:
    @pytest.mark.parametrize("rho", [0.5, -0.5])
    @pytest.mark.parametrize("block", [(2, 2), (4, 4), (2, 8)])
    def test_fast_path_matches_reference(self, rho, block):
        cfg = HDPConfig(rho_b=rho, block_q=block[0], block_k=block[1],
                        tau_h=0.0, normalize_head_score=True)
        q, k, v = (rnd(2, 3, 16, 8, seed=s) for s in (1, 2, 3))
        out_f, st_f, jout_f, jst_f = _hdp_both(
            hdp_attention, jhdp.hdp_attention, q, k, v, cfg)
        out_r, st_r, jout_r, jst_r = _hdp_both(
            hdp_attention_reference, jhdp.hdp_attention_reference, q, k, v,
            cfg)
        np.testing.assert_allclose(out_f.numpy(), out_r.numpy(), rtol=2e-4,
                                   atol=2e-5)
        _eq(st_f.keep_blocks.numpy(), st_r.keep_blocks.numpy())
        _eq(st_f.head_kept.numpy(), st_r.head_kept.numpy())
        _close(out_f, jout_f, TOL_ATTN)
        _close(out_r, jout_r, TOL_ATTN)
        _same_stats(st_f, jst_f)
        _same_stats(st_r, jst_r)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("rho", [0.5, -0.5])
    def test_approx_softmax_matches_jax(self, rho, causal):
        cfg = HDPConfig(rho_b=rho, block_q=4, block_k=4, causal=causal,
                        approx_softmax=True)
        q, k, v = (rnd(2, 3, 18, 8, seed=s, scale=3.0) for s in (4, 5, 6))
        for fn, jfn in ((hdp_attention, jhdp.hdp_attention),
                        (hdp_attention_reference,
                         jhdp.hdp_attention_reference)):
            out, st, jout, jst = _hdp_both(fn, jfn, q, k, v, cfg)
            _close(out, jout, TOL_ATTN)
            _same_stats(st, jst)
        exact, _ = hdp_attention(_t(q), _t(k), _t(v),
                                 cfg.replace(approx_softmax=False))
        out, _ = hdp_attention(_t(q), _t(k), _t(v), cfg)
        assert 0 < float((out - exact).abs().max()) < 0.05

    def test_identity_three_term_equals_qk_minus_ff(self):
        x = _t(rnd(32, 16, seed=8))
        y = _t(rnd(24, 16, seed=9))
        _, ix, fx = quantize_and_split(x)
        _, iy, fy = quantize_and_split(y)
        three = ix @ iy.T + ix @ fy.T + fx @ iy.T
        ident = (ix + fx) @ (iy + fy).T - fx @ fy.T
        np.testing.assert_allclose(three.numpy(), ident.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_disabled_matches_dense(self):
        cfg = HDPConfig(enabled=False)
        q, k, v = (rnd(2, 16, 8, seed=s) for s in (4, 5, 6))
        out, st, jout, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                       q, k, v, cfg)
        ref = dense_attention_reference(_t(q), _t(k), _t(v))
        assert st is None and jst is None
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        _close(out, jout, TOL_ATTN)
        _close(ref, jax.jit(jhdp.dense_attention_reference)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), TOL_ATTN)

    def test_no_pruning_equals_quantized_dense(self):
        # no pruning at all: block_pruning, head_pruning and approx off;
        # calib="none" pins the paper-literal grid
        cfg = HDPConfig(block_pruning=False, head_pruning=False,
                        approx=False, calib="none")
        q, k, v = (rnd(2, 16, 8, seed=s) for s in (7, 8, 9))
        out, _, jout, _ = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                    q, k, v, cfg)
        ref = dense_attention_reference(quantize_fixed(_t(q)),
                                        quantize_fixed(_t(k)), _t(v))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        _close(out, jout, TOL_ATTN)

    def test_no_pruning_calibrated_close_to_dense(self):
        cfg = HDPConfig(block_pruning=False, head_pruning=False,
                        approx=False, calib="max")
        q, k, v = (rnd(2, 16, 8, seed=s) for s in (7, 8, 9))
        out, _, jout, _ = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                    q, k, v, cfg)
        ref = dense_attention_reference(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-2,
                                   atol=2e-3)
        _close(out, jout, TOL_ATTN)

    def test_head_pruning_zeroes_output(self):
        cfg = HDPConfig(tau_h=1e12, normalize_head_score=False)  # prune all
        q, k, v = (rnd(2, 16, 8, seed=s) for s in (10, 11, 12))
        out, st, jout, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                       q, k, v, cfg)
        assert not bool(st.head_kept.any())
        np.testing.assert_allclose(out.numpy(), 0.0)
        assert float(st.head_sparsity) == 1.0
        _same_stats(st, jst)

    def test_tau_zero_keeps_typical_heads(self):
        cfg = HDPConfig(tau_h=0.0)
        q, k, v = (rnd(4, 32, 16, seed=s, scale=3.0) for s in (13, 14, 15))
        out, st, jout, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                       q, k, v, cfg)
        assert bool(st.head_kept.all())
        assert float(st.head_sparsity) == 0.0
        _close(out, jout, TOL_ATTN)
        _same_stats(st, jst)

    def test_causal_masking(self):
        cfg = HDPConfig(causal=True, block_pruning=False, head_pruning=False,
                        approx=False, calib="none")
        q, k, v = (rnd(16, 8, seed=s) for s in (16, 17, 18))
        out, _, jout, _ = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                    q, k, v, cfg)
        ref = dense_attention_reference(quantize_fixed(_t(q)),
                                        quantize_fixed(_t(k)), _t(v),
                                        causal=True)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        _close(out, jout, TOL_ATTN)

    def test_higher_rho_prunes_more(self):
        q, k, v = (rnd(2, 64, 16, seed=s, scale=3.0) for s in (19, 20, 21))
        sp = []
        for rho in (0.1, 0.5, 0.9):
            _, st, _, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                      q, k, v, HDPConfig(rho_b=rho))
            _same_stats(st, jst)
            sp.append(float(st.block_sparsity))
        assert sp[0] <= sp[1] <= sp[2]
        assert sp[2] > 0.3

    def test_decode_mode_kv_blocks(self):
        # Lq = 1 with block_q = 1: KV-block pruning for decode
        cfg = HDPConfig(block_q=1, block_k=4, causal=True)
        q = rnd(1, 16, seed=22)
        k = rnd(64, 16, seed=23, scale=3.0)
        v = rnd(64, 16, seed=24)
        out, st, jout, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                       q, k, v, cfg, q_offset=63)
        assert out.shape == (1, 16)
        assert st.keep_blocks.shape == (1, 16)
        assert not bool(torch.isnan(out).any())
        _close(out, jout, TOL_ATTN)
        _same_stats(st, jst)

    def test_kv_len_bound(self):
        cfg = HDPConfig(block_q=2, block_k=4, causal=True)
        q, k, v = (rnd(2, 12, 8, seed=s) for s in (60, 61, 62))
        out, st, jout, jst = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                       q, k, v, cfg, kv_len=9)
        _close(out, jout, TOL_ATTN)
        _same_stats(st, jst)

    def test_approximation_error_small(self):
        q, k, v = (rnd(4, 64, 32, seed=s) for s in (25, 26, 27))
        _, iq, fq = quantize_and_split(_t(q))
        _, ik, fk = quantize_and_split(_t(k))
        full = (iq + fq) @ (ik + fk).transpose(-1, -2)
        ff = fq @ fk.transpose(-1, -2)
        assert float(torch.linalg.norm(ff) / torch.linalg.norm(full)) < 0.10
        cfg = HDPConfig(block_pruning=False, head_pruning=False, approx=True)
        out, _, jout, _ = _hdp_both(hdp_attention, jhdp.hdp_attention,
                                    q, k, v, cfg)
        ref = dense_attention_reference(_t(q), _t(k), _t(v))
        cos = float((out * ref).sum()
                    / (torch.linalg.norm(out) * torch.linalg.norm(ref)))
        assert cos > 0.98
        _close(out, jout, TOL_ATTN)


# ------------------------------------------------------------------- Top-K
class TestTopK:
    def test_keep_ratio_exact(self):
        s = rnd(16, 16, seed=28)
        keep = topk_block_mask(_t(s), 2, 2, keep_ratio=0.25)
        assert keep.shape == (8, 8)
        np.testing.assert_array_equal(keep.sum(-1).numpy(), 2)
        _eq(keep.numpy(), jtopk.topk_block_mask(jnp.asarray(s), 2, 2, 0.25))

    def test_topk_oracle_keeps_biggest(self):
        s = np.zeros((4, 8), np.float32)
        s[0, 0], s[0, 5] = 100.0, 50.0
        keep = topk_block_mask(_t(s), 2, 2, keep_ratio=0.5)
        assert bool(keep[0, 0]) and bool(keep[0, 2])
        # rows of equal blocks: every tie at the k-th value is kept
        _eq(keep.numpy(), jtopk.topk_block_mask(jnp.asarray(s), 2, 2, 0.5))

    @pytest.mark.parametrize("ratio", [0.3, 0.5])
    def test_topk_with_valid_exact(self, ratio):
        s = rnd(2, 16, 24, seed=70)
        valid = np.asarray(jblocking.causal_block_valid(16, 24, 4, 4))
        keep = topk_block_mask(_t(s), 4, 4, ratio, _t(valid))
        _eq(keep.numpy(), jtopk.topk_block_mask(
            jnp.asarray(s), 4, 4, ratio, jnp.asarray(valid)))

    def test_topk_attention_runs(self):
        q, k, v = (rnd(2, 32, 16, seed=s) for s in (29, 30, 31))
        out, keep = topk_attention(_t(q), _t(k), _t(v), 2, 2, 0.5,
                                   causal=True)
        assert out.shape == q.shape
        assert not bool(torch.isnan(out).any())
        jout, jkeep = jax.jit(functools.partial(
            jtopk.topk_attention, block_q=2, block_k=2, keep_ratio=0.5,
            causal=True))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        _eq(keep.numpy(), jkeep)
        _close(out, jout, TOL_ATTN)

    def test_mask_agreement_and_net_sparsity_exact(self):
        g = np.random.default_rng(71)
        a, b = g.random((2, 3, 4, 5)) < 0.5, g.random((2, 3, 4, 5)) < 0.4
        _eq(mask_agreement(_t(a), _t(b)).numpy(),
            jtopk.mask_agreement(jnp.asarray(a), jnp.asarray(b)))
        heads = g.random((2, 3)) < 0.7
        valid = g.random((4, 5)) < 0.8
        for val in (None, valid):
            got = blocking.net_sparsity(
                _t(a), _t(heads)[..., None, None],
                None if val is None else _t(val))
            want = jblocking.net_sparsity(
                jnp.asarray(a), jnp.asarray(heads)[..., None, None],
                None if val is None else jnp.asarray(val))
            for x, y in zip(got, want):
                _eq(x.numpy(), y)


# ---------------------------------------- approx_softmax through the model
def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def approx_qwen():
    """Reduced qwen2-1.5b with the paper's polynomial softmax, and one
    set of seeded weights as the JAX tree and the port's dict."""
    cfg = reduced(get_config("qwen2-1.5b"))
    cfg = cfg.replace(hdp=cfg.hdp.replace(approx_softmax=True))
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(approx_softmax=True))
    tree = _numpy_tree(registry.init_params(cfg, 0, "cpu"))
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        params_from_jax(cfg, tree, "cpu")


def test_hdp_prefill_approx_softmax_logits(approx_qwen):
    """The serving prefill (``xla_hdp`` into a request cache, K/V round
    tripped through the int8 pool grid) with approx_softmax: logits
    within 1e-4 of JAX's, sparsity equal, and apart from the exact
    softmax's."""
    cfg, jcfg, jparams, params = approx_qwen
    toks = np.random.default_rng(3).integers(1, 250, (2, 24))
    spec = TSpec(backend="xla", kv_dtype="int8")
    with torch.no_grad():
        lg, _, st = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks)},
            registry.init_cache(cfg, 2, 32, device="cpu"), attn=spec,
            collect_stats=True)
        elg, _, _ = registry.apply_prefill(
            cfg.replace(hdp=cfg.hdp.replace(approx_softmax=False)), params,
            {"tokens": torch.from_numpy(toks)},
            registry.init_cache(cfg, 2, 32, device="cpu"), attn=spec)
    jlg, _, jst = jregistry.apply_prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks)},
        jregistry.init_cache(jcfg, 2, 32),
        attn=JSpec(backend="xla", kv_dtype="int8"), collect_stats=True)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    _eq(st["block_sparsity"].numpy(), jst.block_sparsity)
    _eq(st["head_sparsity"].numpy(), jst.head_sparsity)
    assert float((lg - elg).abs().max()) > 1e-4


def test_serving_approx_softmax_tokens_equal_jax(approx_qwen):
    cfg, jcfg, jparams, params = approx_qwen
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, size=int(n)).tolist()
               for n in (7, 19, 30, 40)]     # the last one chunked
    eng = Engine(cfg, params, device="cpu", **kw)
    jeng = JEngine(jcfg, params=jparams,
                   attn=JSpec(backend="xla", kv_dtype="int8"),
                   decode_horizon=1, prefix_cache=False, spec_decode=False,
                   stream_sched=False, **kw)
    for e, cls in ((eng, Request), (jeng, JRequest)):
        for uid, p in enumerate(prompts):
            e.submit(cls(uid, p, max_new_tokens=6))
    out, jout = eng.run(), jeng.run()
    assert {u: r.tokens for u, r in out.items()} == \
        {u: r.tokens for u, r in jout.items()}
    s = eng.summary()
    assert s["attn_backend_prefill"] == jeng.resolved_backend("prefill")
    assert s["attn_backend_decode"] == jeng.resolved_backend("decode") \
        == "paged_hdp_decode"


@pytest.mark.parametrize("call", [
    dict(mode="prefill"), dict(mode="prefill", self_aligned=True),
    dict(mode="decode", paged=True, per_slot=True),
    dict(mode="decode", paged=True, per_slot=True, verify=True),
    dict(mode="decode", per_slot=True)])
@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_registry_resolves_approx_softmax_alike(call, backend, monkeypatch):
    """A call with approx_softmax resolves to one backend in both
    packages (the reference resolving as on its TPU, whose priorities
    the port's registry carries): the kernel backends decline the
    flag."""
    from repro.attention import registry as jreg
    monkeypatch.setattr(jreg, "_on_tpu", lambda: True)
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    cfg = reduced(get_config("qwen2-1.5b"))
    cfg = cfg.replace(hdp=cfg.hdp.replace(approx_softmax=True))
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(approx_softmax=True))
    from repro_torch.attention import AttnSpec
    got = resolve_backend(build_attn_call(cfg, **call),
                          AttnSpec(backend=backend)).name
    want = jresolve(jbuild(jcfg, **call), JSpec(backend=backend)).name
    assert got == want
    assert not got.startswith("pallas")
