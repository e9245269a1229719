"""Port parity: ``repro_torch.core`` against ``repro.core``.

Inputs are made with numpy from a seed and fed to both packages. The
codecs, the poison channels, the fixed-point split, the row thresholds
(both rho branches) and the decode scout must match EXACTLY: on
integer-valued and grid-snapped inputs every operation is exact in fp32
in either framework.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import blocking as jblocking
from repro.core import quant as jq
from repro.core.config import HDPConfig as JHDPConfig
from repro.core.hdp import calibrated_split as j_calibrated_split
from repro.core.hdp import decode_scout as j_decode_scout
from repro_torch.configs import get_config, reduced
from repro_torch.core import blocking as tblocking
from repro_torch.core import quant as tq
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import calibrated_split, decode_scout

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def _eq(a_torch, a_jax):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(a_jax))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_configs_match_field_for_field():
    for arch in ("qwen2-1.5b", "granite-8b", "h2o-danube-1.8b"):
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (reduced(get_config(arch)),
                           jax_reduced(jax_get_config(arch)))):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
            assert cfg.hd == jcfg.hd
    assert dataclasses.asdict(HDPConfig()) == dataclasses.asdict(JHDPConfig())


@pytest.mark.parametrize("int_bits,frac_bits", [(4, 12), (2, 6), (6, 8)])
def test_quantize_and_split_exact(rng, int_bits, frac_bits):
    x = np.concatenate([rng.normal(0, 6, 4000),
                        # exact half-grid ties: round half to even
                        (np.arange(-40, 40) + 0.5) / 2.0 ** frac_bits,
                        [1e9, -1e9]]).astype(np.float32)
    for a, b in zip(tq.quantize_and_split(_t(x), int_bits, frac_bits),
                    jq.quantize_and_split(jnp.asarray(x), int_bits,
                                          frac_bits)):
        _eq(a, b)


@pytest.mark.parametrize("int_bits", [2, 4, 6])
def test_pool_codecs_exact(rng, int_bits):
    s0 = tq.pool_scale(int_bits)
    assert s0 == jq.pool_scale(int_bits)
    lim = 127 * s0
    x = np.concatenate([rng.uniform(-lim, lim, 3000),
                        rng.uniform(lim, 64 * lim, 50),
                        -rng.uniform(lim, 64 * lim, 50),
                        (np.arange(-20, 20) + 0.5) * s0]).astype(np.float32)
    codes = tq.encode_pool(_t(x), int_bits)
    assert codes.dtype == torch.int8 and int(codes.min()) >= -127
    _eq(codes, jq.encode_pool(jnp.asarray(x), int_bits))
    _eq(tq.roundtrip_pool(_t(x), int_bits),
        jq.roundtrip_pool(jnp.asarray(x), int_bits))
    c = codes.numpy()
    _eq(tq.decode_pool(codes, s0), jq.decode_pool(jnp.asarray(c), s0))
    _eq(tq.pool_view_finite(codes, int_bits),
        jq.pool_view_finite(jnp.asarray(c), int_bits))


def test_poison_channels():
    ib = 4
    s0 = tq.pool_scale(ib)
    assert tq.POISON_CODE == jq.POISON_CODE == -128
    codes = np.asarray([[5, tq.POISON_CODE, -127]], np.int8)
    dq = tq.decode_pool(_t(codes), s0).numpy()
    jdq = np.asarray(jq.decode_pool(jnp.asarray(codes), s0))
    np.testing.assert_array_equal(np.isnan(dq), np.isnan(jdq))
    assert dq[0, 0] == 5 * s0 and np.isnan(dq[0, 1])
    view = tq.pool_view_finite(_t(codes), ib).numpy()
    assert np.isfinite(view).all() and view[0, 1] == 0.0
    _eq(tq.pool_view_finite(_t(codes), ib),
        jq.pool_view_finite(jnp.asarray(codes), ib))
    # a NaN page scale poisons every dequant of the page
    assert torch.isnan(tq.decode_pool(_t(codes),
                                      torch.tensor(float("nan")))).all()


@pytest.mark.parametrize("mode", ["max", "none"])
def test_calibrated_split_exact(rng, mode):
    cfg = HDPConfig(calib=mode)
    jcfg = JHDPConfig(calib=mode)
    x = rng.normal(0, 3, (2, 3, 40, 16)).astype(np.float32)
    for a, b in zip(calibrated_split(_t(x), cfg),
                    j_calibrated_split(jnp.asarray(x), jcfg)):
        _eq(a, b)


def test_calib_scale_rms_close(rng):
    """"rms" sums squares of non-integers, so the two frameworks' sum
    orders differ in the last bits: held to 4 ULP of fp32."""
    x = rng.normal(0, 3, (2, 3, 40, 16)).astype(np.float32)
    got = float(tq.calib_scale(_t(x), 4, "rms"))
    want = float(jq.calib_scale(jnp.asarray(x), 4, "rms"))
    assert got == pytest.approx(want, rel=4 * 2.0 ** -23)


@pytest.mark.parametrize("rho", [0.5, 0.0, -0.3, 0.9])
@pytest.mark.parametrize("with_valid", [True, False])
def test_row_threshold_and_keep_exact(rng, rho, with_valid):
    theta = rng.integers(0, 4000, (3, 4, 5, 12)).astype(np.float32)
    valid = rng.random((3, 4, 5, 12)) < 0.7 if with_valid else None
    tv = _t(valid) if with_valid else None
    jv = jnp.asarray(valid) if with_valid else None
    thr = tblocking.row_threshold(_t(theta), rho, tv)
    jthr = jblocking.row_threshold(jnp.asarray(theta), rho, jv)
    _eq(thr, jthr)
    _eq(tblocking.block_keep_mask(_t(theta), thr, tv),
        jblocking.block_keep_mask(jnp.asarray(theta), jthr, jv))


@pytest.mark.parametrize("Sq", [1, 3])
@pytest.mark.parametrize("knobs", [
    dict(),
    dict(rho_b=-0.4, tau_h=0.05),
    dict(block_pruning=False, normalize_head_score=False),
    dict(head_pruning=False, rho_b=0.8),
])
def test_decode_scout_exact(rng, Sq, knobs):
    """Integer-valued scores (as the scout's are) -> identical keep mask,
    block validity, importances and head gate."""
    B, N, G, ps, nP = 2, 2, 3, 4, 6
    knobs = {"normalize_head_score": True, **knobs}
    cfg = HDPConfig(block_k=ps, **knobs)
    jcfg = JHDPConfig(block_k=ps, **knobs)
    s = rng.integers(-300, 300, (B, N, G, Sq, nP * ps)).astype(np.float32)
    kv_len = np.array([nP * ps - 5, 9])
    valid = (np.arange(nP * ps)[None, :] < kv_len[:, None])
    valid = np.broadcast_to(valid[:, None, None, None, :],
                            (B, 1, 1, Sq, nP * ps)).copy()
    got = decode_scout(_t(s), _t(valid), cfg)
    want = j_decode_scout(jnp.asarray(s), jnp.asarray(valid), jcfg)
    for a, b in zip(got, want):
        _eq(a, np.broadcast_to(np.asarray(b), tuple(a.shape)))
