"""Hypothesis property tests of HDP's algebraic invariants on the port.

The port of ``tests/test_property_hdp.py``: the same identities
(quantization algebra, threshold monotonicity, row balance, softmax
exclusion, the polynomial exp's error bound, net-sparsity bounds, the
end-to-end attention's sanity), on ``repro_torch.core``, each draw also
fed to the reference's function with the port's result held against it.
Every property runs under a fixed seed with ``derandomize=True`` and no
example database, so a run draws the same examples every time: a
failure here is a fault, never an unlucky draw.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings, strategies as st
from hypothesis.extra import numpy as hnp

from repro.core import blocking as jblocking
from repro.core.hdp import hdp_attention as j_hdp_attention
from repro.core.quant import calib_scale as j_calib_scale
from repro.core.quant import quantize_fixed as j_quantize_fixed
from repro_torch.core import blocking
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import hdp_attention
from repro_torch.core.quant import calib_scale, int_frac_split, quantize_fixed

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

SETTINGS = dict(max_examples=40, deadline=None, derandomize=True,
                database=None)

floats = st.floats(min_value=-15.0, max_value=15.0,
                   allow_nan=False, allow_infinity=False, width=32)


def arrays(shape):
    return hnp.arrays(np.float32, shape, elements=floats)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


class TestQuantProperties:
    @seed(101)
    @given(arrays((8, 8)))
    @settings(**SETTINGS)
    def test_split_reconstructs_and_bounds(self, x):
        xq = quantize_fixed(_t(x))
        i, f = int_frac_split(xq)
        i, f, xq = i.numpy(), f.numpy(), xq.numpy()
        assert np.allclose(i + f, xq, atol=1e-6)
        assert np.all(i == np.trunc(i))
        assert np.all(np.abs(f) < 1.0)
        # signs agree: trunc-toward-zero keeps F on x's side
        assert np.all(i * xq >= 0)
        np.testing.assert_array_equal(xq, j_quantize_fixed(jnp.asarray(x)))

    @seed(102)
    @given(arrays((6, 6)))
    @settings(**SETTINGS)
    def test_quantize_idempotent_and_error_bound(self, x):
        xq = quantize_fixed(_t(x))
        xqq = quantize_fixed(xq)
        assert torch.equal(xq, xqq)
        # inside the representable range the error is at most half a step
        step = 2.0 ** -12
        inside = np.abs(x) < 15.9
        err = np.abs(xq.numpy() - x)[inside]
        assert np.all(err <= step / 2 + 1e-9)

    @seed(103)
    @given(arrays((5, 7)), arrays((6, 7)))
    @settings(**SETTINGS)
    def test_three_term_identity(self, x, y):
        """II + IF + FI == (I+F)(I+F) - FF for any quantized tensors."""
        xq = quantize_fixed(_t(x))
        yq = quantize_fixed(_t(y))
        ix, fx = int_frac_split(xq)
        iy, fy = int_frac_split(yq)
        three = ix @ iy.T + ix @ fy.T + fx @ iy.T
        ident = xq @ yq.T - fx @ fy.T
        assert np.allclose(three.numpy(), ident.numpy(), rtol=1e-4,
                           atol=1e-3)

    @seed(104)
    @given(arrays((4, 16)), st.sampled_from(["max", "rms"]))
    @settings(**SETTINGS)
    def test_calibration_in_range(self, x, mode):
        s = calib_scale(_t(x), 4, mode)
        assert float(s) > 0
        if mode == "max":
            scaled = np.abs(x * float(s))
            assert scaled.max() <= 16.0 + 1e-4
        np.testing.assert_allclose(
            float(s), float(j_calib_scale(jnp.asarray(x), 4, mode)),
            rtol=1e-6)


class TestThresholdProperties:
    @seed(105)
    @given(hnp.arrays(np.float32, (3, 4, 8),
                      elements=st.floats(0, 100, width=32)),
           st.floats(-0.95, 0.95))
    @settings(**SETTINGS)
    def test_threshold_between_min_and_max(self, theta, rho):
        thr = blocking.row_threshold(_t(theta), rho).numpy()
        lo = theta.min(-1, keepdims=True) - 1e-4
        hi = theta.max(-1, keepdims=True) + 1e-4
        assert np.all(thr >= lo)
        assert np.all(thr <= hi)
        np.testing.assert_allclose(
            thr, jblocking.row_threshold(jnp.asarray(theta), rho),
            rtol=1e-5, atol=1e-5)

    @seed(106)
    @given(hnp.arrays(np.float32, (2, 5, 6),
                      elements=st.floats(0, 50, width=32)))
    @settings(**SETTINGS)
    def test_threshold_monotone_in_rho(self, theta):
        t = _t(theta)
        rhos = (-0.8, -0.4, 0.0, 0.4, 0.8)
        ths = [blocking.row_threshold(t, r).numpy() for r in rhos]
        for a, b in zip(ths, ths[1:]):
            assert np.all(b >= a - 1e-4)

    @seed(107)
    @given(hnp.arrays(np.float32, (3, 6, 8),
                      elements=st.floats(0, 50, width=32)),
           st.floats(-0.9, 0.9))
    @settings(**SETTINGS)
    def test_row_balance_every_row_keeps_one(self, theta, rho):
        """Row-balanced sparsity: the max block of every row survives
        (Theta <= max by construction), so no row is fully pruned; a
        one-ulp tolerance covers a constant row (Theta == max up to
        rounding)."""
        thr = blocking.row_threshold(_t(theta), rho).numpy()
        tol = 1e-4 + 1e-5 * np.abs(thr)
        keep = theta >= (thr - tol)
        assert bool(np.all(keep.any(axis=-1)))


class TestSoftmaxProperties:
    @seed(108)
    @given(hnp.arrays(np.float32, (4, 8), elements=floats),
           hnp.arrays(np.bool_, (4, 8), elements=st.booleans()))
    @settings(**SETTINGS)
    def test_masked_softmax_partition(self, s, keep):
        for fn, jfn, tol in (
                (blocking.masked_softmax, jblocking.masked_softmax, 1e-5),
                (blocking.approx_softmax, jblocking.approx_softmax, 2e-3)):
            p = fn(_t(s), _t(keep)).numpy()
            # excluded entries carry zero probability
            assert np.all(p[~keep] == 0)
            sums = p.sum(-1)
            has = keep.any(-1)
            assert np.allclose(sums[has], 1.0, atol=tol)
            assert np.allclose(sums[~has], 0.0, atol=1e-6)
            np.testing.assert_allclose(
                p, jfn(jnp.asarray(s), jnp.asarray(keep)), atol=1e-6)

    @seed(109)
    @given(hnp.arrays(np.float32, (3, 16),
                      elements=st.floats(-30, 0, width=32)))
    @settings(**SETTINGS)
    def test_poly_exp_relative_error(self, x):
        e = blocking.poly_exp(_t(x)).numpy()
        ref = np.exp(x)
        assert np.all(np.abs(e - ref) <= 0.04 * ref + 1e-6)
        np.testing.assert_allclose(e, jblocking.poly_exp(jnp.asarray(x)),
                                   atol=1e-6)


class TestNetSparsityProperties:
    @seed(110)
    @given(hnp.arrays(np.bool_, (2, 3, 4, 4), elements=st.booleans()),
           hnp.arrays(np.bool_, (2, 3), elements=st.booleans()))
    @settings(**SETTINGS)
    def test_net_sparsity_bounds(self, keep, heads):
        got = blocking.net_sparsity(_t(keep), _t(heads)[..., None, None])
        bsp, hsp, net = (float(v) for v in got)
        for v in (bsp, hsp, net):
            assert -1e-6 <= v <= 1.0 + 1e-6
        # net >= head sparsity (a pruned head prunes all its blocks)
        assert net >= hsp - 1e-5
        want = jblocking.net_sparsity(
            jnp.asarray(keep), jnp.asarray(heads)[..., None, None])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class TestEndToEndProperties:
    @seed(111)
    @given(st.integers(0, 2 ** 31 - 1), st.floats(-0.9, 0.9),
           st.booleans(), st.booleans())
    @settings(max_examples=10, deadline=None, derandomize=True,
              database=None)
    def test_hdp_attention_finite_and_sane(self, seed_, rho, causal,
                                           approx_softmax):
        rng = np.random.default_rng(seed_)
        q, k, v = (rng.normal(size=(2, 16, 8)).astype(np.float32)
                   for _ in range(3))
        cfg = HDPConfig(rho_b=rho, causal=causal, tau_h=0.0,
                        normalize_head_score=True,
                        approx_softmax=approx_softmax)
        out, st_ = hdp_attention(_t(q), _t(k), _t(v), cfg)
        assert bool(torch.isfinite(out).all())
        # a convex combination of V rows per kept head: bounded (the
        # polynomial unit's row sums are 1 within its error)
        bound = np.abs(v).max() * (1.01 if approx_softmax else 1.0)
        assert float(out.abs().max()) <= bound + 1e-4
        assert 0.0 <= float(st_.net_sparsity) <= 1.0
        from repro.core.config import HDPConfig as JHDPConfig
        jout, jst = j_hdp_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), JHDPConfig(**cfg.__dict__))
        np.testing.assert_array_equal(st_.keep_blocks.numpy(),
                                      np.asarray(jst.keep_blocks))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


@pytest.mark.parametrize("fn", [blocking.poly_exp, blocking.linear_reciprocal])
def test_polynomial_unit_keeps_shape_and_dtype(fn):
    x = torch.linspace(-3.0, 3.0, 12).reshape(3, 4)
    y = fn(x.abs() if fn is blocking.linear_reciprocal else -x.abs())
    assert y.shape == x.shape and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
