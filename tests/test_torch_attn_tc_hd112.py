"""The tensor-core attention paths at head size 112 (zamba2-7b's), on the
CPU.

At hd 112 the tensor-core kernels keep their tiles 128 columns wide in
shared memory and zero columns 112-127: the limb products and P.V then
add exact +0 terms. Here the limb score of zero-padded limbs is held
equal to the unpadded one bit for bit, and an attention built on the
padded limbs and V to the plain version (1e-4 with fp32 V, 2e-2 with
bf16 V, where p is rounded to bf16 before P.V). The wrappers' path
choice sends zamba2-7b's bf16 prefill shape to the tensor-core kernels
and fp32 at hd 112 to the tile kernels, and the launchers' head sizes
are the wrappers' list. Last, the port's plain versions at hd 112 are
held against the JAX package's kernels in interpret mode (as
``tests/test_kernels.py`` runs them) within the reference's 2e-3, and
2e-2 with bf16 operands. The kernels themselves run only on the card
(``chip_smoke.py`` phases 3 and 5i)."""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_fixed as jquantize_fixed
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.hdp_block_attn import \
    hdp_block_sparse_attention as jblock
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention, flash_path
from repro_torch.kernels.hdp_block_attn import (TC_HEAD_DIMS, block_path,
                                                fixed_limbs,
                                                hdp_block_sparse_attention)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

HD, WIDTH = 112, 128        # zamba2-7b's head size; the kernels' tile width
TOL, TOL_BF16 = 1e-4, 2e-2
JAX_TOL = 2e-3              # the reference's kernel tests' tolerance
F64 = torch.float64
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def rnd(*shape, seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def grid(shape, seed, scale=2.0):
    """Seeded values on the Q4.12 grid, through the reference's codec."""
    return np.array(jquantize_fixed(jnp.asarray(rnd(*shape, seed=seed,
                                                      scale=scale))))


def pad(x):
    """x [..., HD] zero-padded to the kernels' WIDTH columns."""
    return torch.nn.functional.pad(x, (0, WIDTH - x.shape[-1]))


def limb_score(q, k, approx=True, padded=False):
    """QQ·KQᵀ − FQ·FKᵀ (or QQ·KQᵀ) from the limbs, summed in float64;
    with ``padded`` from limbs zero-padded to WIDTH columns, as the
    kernels hold them in shared memory."""
    lq = [t.to(F64) for t in fixed_limbs(q)]
    lk = [t.to(F64) for t in fixed_limbs(k)]
    if padded:
        lq, lk = [pad(t) for t in lq], [pad(t) for t in lk]
    (iq, hq, loq), (ik, hk, lok) = lq, lk
    s = iq @ ik.T + iq @ hk.T + iq @ lok.T + hq @ ik.T + loq @ ik.T
    if not approx:
        s = s + hq @ hk.T + hq @ lok.T + loq @ hk.T + loq @ lok.T
    return s


def _lists(keep, theta, max_keep):
    jidx, jcnt = jref.keep_mask_to_indices(jnp.asarray(keep),
                                           jnp.asarray(theta), max_keep)
    return (jidx, jcnt), (torch.from_numpy(np.array(jidx)),
                          torch.from_numpy(np.array(jcnt)))


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ path choice
def test_zamba2_prefill_takes_the_tensor_core_paths():
    cfg = get_config("zamba2-7b")
    shape = (cfg.hd, cfg.hdp.block_q, cfg.hdp.block_k)
    assert shape == (HD, 128, 128)
    assert HD in TC_HEAD_DIMS
    assert block_path(torch.bfloat16, *shape) == "tensor_core"
    assert flash_path(torch.bfloat16, *shape) == "tensor_core"
    assert block_path(torch.bfloat16, HD, 64, 128) == "tensor_core"
    assert block_path(torch.bfloat16, HD, 128, 64) == "tensor_core"
    # fp32 at hd 112 stays on the tile kernels, as do blocks the
    # tensor-core block kernel does not take and other head sizes
    assert flash_path(torch.float32, *shape) == "tile"
    assert block_path(torch.float32, *shape) == "tile"
    assert block_path(torch.bfloat16, HD, 32, 128) == "tile"
    for hd in (16, 32, 96, 120):
        assert flash_path(torch.bfloat16, hd, 128, 128) == "tile"
        assert block_path(torch.bfloat16, hd, 128, 128) == "tile"
    with pytest.raises(ValueError):
        flash_path(torch.bfloat16, 256, 128, 128)


@pytest.mark.parametrize("source", ["flash_attention_tc.cu",
                                    "hdp_block_attn_tc.cu"])
def test_launchers_take_the_listed_head_sizes(source):
    """Each tensor-core launcher dispatches on exactly TC_HEAD_DIMS (any
    other head size returns cudaErrorInvalidValue)."""
    text = (CSRC / source).read_text()
    launcher = text[text.index('extern "C"'):]
    taken = {int(h) for h in re.findall(r"\bhd == (\d+)", launcher)}
    assert taken == set(TC_HEAD_DIMS)
    assert "cudaErrorInvalidValue" in launcher


# ------------------------------------------------- the padded limb scores
@pytest.mark.parametrize("approx", [True, False])
def test_padded_limb_score_equals_unpadded_exactly(approx):
    q = torch.from_numpy(grid((70, HD), 1, scale=6.0))
    k = torch.from_numpy(grid((90, HD), 2, scale=6.0))
    got = limb_score(q, k, approx, padded=True)
    assert torch.equal(got, limb_score(q, k, approx))
    for limb in fixed_limbs(q):
        assert float(pad(limb)[..., HD:].abs().max()) == 0.0


@pytest.mark.parametrize("causal,approx,v_dtype", [
    (True, True, torch.float32), (False, True, torch.float32),
    (True, False, torch.float32), (True, True, torch.bfloat16)])
def test_padded_limb_attention_matches_plain(causal, approx, v_dtype):
    B, H, S, blk = 1, 2, 256, 64
    q = torch.from_numpy(grid((B, H, S, HD), 3))
    k = torch.from_numpy(grid((B, H, S, HD), 4))
    v = torch.from_numpy(rnd(B, H, S, HD, seed=5, scale=1.0)).to(v_dtype)
    nq = S // blk
    g = torch.Generator().manual_seed(6)
    keep = torch.rand(B, H, nq, nq, generator=g) < 0.6
    keep[..., 2, :] = False                   # a q tile that lists nothing
    theta = torch.rand(B, H, nq, nq, generator=g)
    idx, cnt = ref.keep_mask_to_indices(keep, theta, nq)
    head_kept = torch.tensor([[True, False]])
    scale = 0.37
    plain = hdp_block_sparse_attention(
        q, k, v, idx, cnt, head_kept, causal=causal, approx=approx,
        block_q=blk, block_k=blk, score_scale=scale)

    listed = torch.zeros(B, H, nq, nq + 1, dtype=torch.bool)
    live = torch.arange(nq) < cnt[..., None]
    listed.scatter_(3, torch.where(live, idx.long(), nq), True)
    valid = listed[..., :nq].repeat_interleave(blk, 2) \
        .repeat_interleave(blk, 3)
    if causal:
        valid &= torch.ones(S, S, dtype=torch.bool).tril()
    # the softmax scale of hd 112, not of the 128-column tiles
    sc = np.float32(1.0 / HD ** 0.5) * np.float32(scale)
    out = torch.zeros(B, H, S, WIDTH)
    for b in range(B):
        for h in range(H):
            if not head_kept[b, h]:
                continue
            s = limb_score(q[b, h], k[b, h], approx, padded=True).float()
            s = torch.where(valid[b, h], s * float(sc), -torch.inf)
            m = s.amax(-1, keepdim=True).clamp(min=-1e30)
            p = torch.where(valid[b, h], torch.exp(s - m), 0.0)
            l = p.sum(-1, keepdim=True).clamp(min=1e-30)
            out[b, h] = (p.to(v_dtype).float() @ pad(v[b, h].float())) / l
    assert float(out[..., HD:].abs().max()) == 0.0   # V's zero columns
    tol = TOL if v_dtype == torch.float32 else TOL_BF16
    np.testing.assert_allclose(out[..., :HD].numpy(), plain.numpy(),
                               rtol=tol, atol=tol)
    assert float(plain[0, 1].abs().max()) == 0.0      # the gated head
    assert float(plain[0, 0, 2 * blk:3 * blk].abs().max()) == 0.0


# ------------------------------------- the plain versions vs JAX's kernels
@pytest.mark.parametrize("causal,approx", [(True, True), (False, False)])
@pytest.mark.parametrize("v_dtype", [None, "bf16"])
def test_block_plain_matches_jax_kernel(causal, approx, v_dtype):
    B, H, S, blk = 1, 2, 256, 128
    q, k = grid((B, H, S, HD), 11), grid((B, H, S, HD), 12)
    v = rnd(B, H, S, HD, seed=13)
    theta, keep, _ = jref.hdp_scout_ref(
        jnp.trunc(jnp.asarray(q)), jnp.trunc(jnp.asarray(k)), block_q=blk,
        block_k=blk, rho_b=-0.5, causal=causal)
    keep, theta = np.asarray(keep), np.asarray(theta)
    (jidx, jcnt), (tidx, tcnt) = _lists(keep, theta, keep.shape[-1])
    hk = np.array([[True, False]])              # the second head gated
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    if v_dtype:
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    want = jblock(jnp.asarray(q), jnp.asarray(k), jv, jidx, jcnt,
                  jnp.asarray(hk), causal=causal, approx=approx,
                  block_q=blk, block_k=blk, interpret=True)
    got = hdp_block_sparse_attention(
        torch.from_numpy(q), torch.from_numpy(k), tv, tidx, tcnt,
        torch.from_numpy(hk), causal=causal, approx=approx, block_q=blk,
        block_k=blk)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, HD)
    close(got, want, TOL_BF16 if v_dtype else JAX_TOL)
    assert float(got[0, 1].abs().max()) == 0.0
    assert float(got[0, 0].abs().max()) > 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_flash_plain_matches_jax_kernel(causal, dtype):
    qkv = [rnd(1, 2, 256, HD, seed=s) for s in (21, 22, 23)]
    js = [jnp.asarray(x) for x in qkv]
    ts = [torch.from_numpy(x) for x in qkv]
    if dtype:
        js = [j.astype(jnp.bfloat16) for j in js]
        ts = [t.to(torch.bfloat16) for t in ts]
    want = jflash(*js, causal=causal, block_q=128, block_k=128,
                  interpret=True)
    got = flash_attention(*ts, causal=causal, block_q=128, block_k=128)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    close(got, want, TOL_BF16 if dtype else JAX_TOL)

