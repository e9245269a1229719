"""The integer scout's tensor-core path at head size 112 (zamba2-7b's), on
the CPU.

At hd 112 the tensor-core kernel runs as at hd 128: its pre-pass writes
int8 copies whose rows are 128 bytes wide, columns 112-127 zero, and the
main kernel issues four k32 steps a block. A zero byte adds an exact 0
to every int32 score, so theta, keep and theta_head stay those of the
unpadded inputs. Here the kernel's arithmetic (``tc_emulation`` of
``tests/test_torch_scout_tc.py``) run on the zero-padded copies must
equal the plain version (``ref.hdp_scout_plain``) at hd 112 bit for bit
on ragged S, causal and full, at 128x128, 64x128 and 128x64 blocks, and
the JAX kernel in interpret mode wherever every block sum stays below
2^24 (values at -128 and 127 are held against the plain version only).
``scout_path`` sends zamba2-7b's aligned-prefill shape to the tensor-core
kernel and the launcher takes hd 112. The kernels themselves run only
on the card (``chip_smoke.py`` phases 3, 5i and 6)."""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hdp_scout import hdp_scout as jscout
from repro_torch.configs import get_config
from repro_torch.kernels.hdp_scout import (PATHS, TC_BLOCKS, TC_PADDED_HD,
                                           hdp_scout, scout_path)
from repro_torch.kernels.ref import hdp_scout_plain
from test_torch_scout_tc import assert_equal, small_ints, tc_emulation

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

HD, WIDTH = 112, 128    # zamba2-7b's head size; the int8 copies' row width
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def padded(x):
    """The pre-pass's copy of integer parts [B,H,S,112]: rows of 128
    values, the last 16 zero."""
    out = np.zeros(x.shape[:-1] + (WIDTH,), x.dtype)
    out[..., :HD] = x
    return out


def plain(iq, ik, **kw):
    return hdp_scout_plain(torch.from_numpy(iq), torch.from_numpy(ik), **kw)


@pytest.mark.parametrize("S", [384, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk,rho", [(128, 128, 0.5), (64, 128, -0.5),
                                       (128, 64, 0.5)])
def test_padded_emulation_equals_plain_and_jax_bit_for_bit(S, causal, bq, bk,
                                                           rho):
    shape = (1, 2, S, HD)
    iq, ik = small_ints(shape, 11), small_ints(shape, 12)
    kw = dict(rho_b=rho, block_q=bq, block_k=bk, causal=causal)
    emu = tc_emulation(padded(iq), padded(ik), **kw)
    assert emu[0].max() < 2 ** 24 and emu[2].max() < 2 ** 24
    assert_equal(plain(iq, ik, **kw), emu)
    assert_equal(jscout(jnp.asarray(iq), jnp.asarray(ik), interpret=True,
                        **kw), emu)
    assert emu[1].any() and not emu[1].all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 64)])
def test_padded_emulation_equals_plain_at_the_int8_extremes(causal, bq, bk):
    """All values at -128 or 127: |s| up to 128 * 128 * 112, block sums
    past 2^24 (where fp32 sums stop being exact), exact in the kernel's
    integers and the plain version's float64."""
    rng = np.random.default_rng(13)
    iq, ik = (np.where(rng.random((1, 1, 300, HD)) < 0.5, -128.0,
                       127.0).astype(np.float32) for _ in range(2))
    ik[:, :, ::3] = -128.0
    kw = dict(rho_b=0.5, block_q=bq, block_k=bk, causal=causal)
    emu = tc_emulation(padded(iq), padded(ik), **kw)
    assert emu[0].max() > 2 ** 24
    assert_equal(plain(iq, ik, **kw), emu)


def test_zero_columns_change_no_score():
    """Each block's |IQ.IKᵀ| sums of the padded copies equal the unpadded
    ones exactly: the padding only adds 0 products."""
    shape = (1, 2, 256, HD)
    iq, ik = small_ints(shape, 14), small_ints(shape, 15)
    kw = dict(rho_b=0.5, block_q=128, block_k=128, causal=False)
    assert_equal(tc_emulation(padded(iq), padded(ik), **kw),
                 tc_emulation(iq, ik, **kw))


def test_scout_path_takes_zamba2_on_tensor_cores():
    cfg = get_config("zamba2-7b")
    assert (cfg.hd, cfg.hdp.block_q, cfg.hdp.block_k) == (HD, 128, 128)
    assert TC_PADDED_HD == HD
    for bq in TC_BLOCKS:
        for bk in TC_BLOCKS:
            assert scout_path(HD, bq, bk) == "tensor_core"
    # other blocks at hd 112 stay on the dp4a kernel, and no other head
    # size that is not a multiple of 32 takes the tensor cores
    assert scout_path(HD, 32, 32) == scout_path(HD, 128, 32) == "dp4a"
    assert scout_path(80, 128, 128) == scout_path(144, 128, 128) == "dp4a"


def test_launcher_takes_hd_112_and_pads_to_128():
    """The C entry's head sizes are the wrapper's: a multiple of 32 up to
    128, or 112, whose copies are rounded up to 32-byte k steps (128)."""
    src = (CSRC / "hdp_scout_tc.cu").read_text()
    entry = src[src.index("int hdp_scout_tc_launch("):]
    assert re.search(rf"hd != {TC_PADDED_HD} && \(hd % 32 \|\| hd < 32 \|\| "
                     r"hd > 128\)", entry)
    assert "const int hdp = (hd + 31) / 32 * 32;" in entry
    assert -(-HD // 32) * 32 == WIDTH


def test_cpu_calls_at_hd_112_run_the_plain_version():
    shape = (1, 2, 300, HD)
    iq = torch.from_numpy(small_ints(shape, 16))
    ik = torch.from_numpy(small_ints(shape, 17))
    kw = dict(rho_b=0.5, block_q=128, block_k=128, causal=True)
    before = dict(hdp_scout.launches_by_path)
    n = hdp_scout.launches
    want = hdp_scout_plain(iq, ik, **kw)
    for path in (None,) + PATHS:
        assert_equal(hdp_scout(iq, ik, path=path, **kw), want)
    # the prefill's strided [B, H, S, hd] views of [B, S, H, hd] tensors
    assert_equal(hdp_scout(iq.transpose(1, 2).contiguous().transpose(1, 2),
                           ik.transpose(1, 2).contiguous().transpose(1, 2),
                           **kw), want)
    assert hdp_scout.launches == n
    assert hdp_scout.launches_by_path == before
