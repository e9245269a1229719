"""The tensor-core paths of the port's attention kernels, on the CPU.

The block-sparse kernel's tensor-core path computes the FUM scores as
five products of exact bf16 limbs of the fixed-point operands
(``hdp_block_attn.fixed_limbs``). Here the limb split is held to exact
reconstruction on seeded grid values made by the JAX package's
``quantize_fixed``, the limb score (in float64) to the exact fixed-point
score, and an attention built on it to the plain version within the
existing 1e-4. The wrappers' path choice is a pure function of dtype and
shape: the aligned prefill's shapes take the tensor-core kernels, fp32,
the paged decode's route and tiny head sizes the tile kernels, and a
shape neither takes raises. The kernels themselves run only on the card
(``chip_smoke.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_fixed as jquantize_fixed
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention, flash_path
from repro_torch.kernels.hdp_block_attn import (block_path, fixed_limbs,
                                                hdp_block_sparse_attention)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TOL = 1e-4
F64 = torch.float64
STEP = 2.0 ** -12


def grid(shape, seed, scale=6.0):
    """Seeded values on the Q4.12 grid, through the reference's codec."""
    x = scale * np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(np.array(
        jquantize_fixed(jnp.asarray(x.astype(np.float32)))))


def edges():
    """The grid's ends and its smallest steps, on both sides of 0."""
    top = 16.0 - STEP
    vals = [-16.0, top, -top, STEP, -STEP, 2 * STEP, 0.0, 1.0 - STEP,
            -(1.0 - STEP), 1.0, -1.0, 15.0 + STEP, -15.0 - STEP,
            0.5 + STEP, -(0.5 + STEP)]
    return torch.tensor(vals, dtype=torch.float32)


def limb_score(q, k, approx=True):
    """QQ·KQᵀ − FQ·FKᵀ (or QQ·KQᵀ) from the limbs, summed in float64."""
    iq, hq, lq = (t.to(F64) for t in fixed_limbs(q))
    ik, hk, lk = (t.to(F64) for t in fixed_limbs(k))
    s = iq @ ik.T + iq @ hk.T + iq @ lk.T + hq @ ik.T + lq @ ik.T
    if not approx:
        s = s + hq @ hk.T + hq @ lk.T + lq @ hk.T + lq @ lk.T
    return s


def test_limb_split_reconstructs_grid_values_exactly():
    x = torch.cat([grid((200_000,), 0).flatten(), edges()])
    i, hi, lo = fixed_limbs(x)
    assert i.dtype == hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(i.to(F64) + hi.to(F64) + lo.to(F64), x.to(F64))
    assert torch.equal(i.float(), torch.trunc(x))
    # the remainder was exact in bf16: rounding it lost nothing
    f = x - torch.trunc(x)
    assert torch.equal(f - hi.float(), lo.float())
    assert float(i.float().abs().max()) == 16.0
    assert float((hi.float() + lo.float()).abs().max()) < 1.0


@pytest.mark.parametrize("approx", [True, False])
def test_limb_score_equals_exact_fixed_point_score(approx):
    e = edges().repeat(3)[:32]
    q = torch.cat([grid((61, 32), 1), e[None], e.flip(0)[None]])
    k = torch.cat([grid((45, 32), 2), -e[None], e.roll(5)[None]])
    # exact: integers in units of 2^-12, products in units of 2^-24
    qi = torch.round(q.to(F64) / STEP).long()
    ki = torch.round(k.to(F64) / STEP).long()
    exact = qi @ ki.T
    if approx:
        fq = qi - torch.trunc(q.to(F64)).long() * 4096
        fk = ki - torch.trunc(k.to(F64)).long() * 4096
        exact = exact - fq @ fk.T
    got = limb_score(q, k, approx) / STEP ** 2
    assert torch.equal(got, exact.to(F64))


@pytest.mark.parametrize("causal,approx,v_dtype", [
    (True, True, torch.float32), (False, True, torch.float32),
    (True, False, torch.float32), (True, True, torch.bfloat16)])
def test_limb_attention_matches_plain(causal, approx, v_dtype):
    B, H, S, hd, blk = 1, 2, 96, 32, 16
    q = grid((B, H, S, hd), 3, scale=2.0)
    k = grid((B, H, S, hd), 4, scale=2.0)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, H, S, hd)).astype(np.float32)).to(v_dtype)
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
    sc = np.float32(1.0 / hd ** 0.5) * np.float32(scale)
    out = torch.zeros(B, H, S, hd)
    for b in range(B):
        for h in range(H):
            if not head_kept[b, h]:
                continue
            s = (limb_score(q[b, h], k[b, h], approx).float() * float(sc))
            s = torch.where(valid[b, h], s, -torch.inf)
            m = s.amax(-1, keepdim=True).clamp(min=-1e30)
            p = torch.where(valid[b, h], torch.exp(s - m), 0.0)
            l = p.sum(-1, keepdim=True).clamp(min=1e-30)
            pv = p.to(v_dtype).float() @ v[b, h].float()
            out[b, h] = pv / l
    tol = TOL if v_dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)
    assert float(out[0, 1].abs().max()) == 0.0        # the gated head
    assert float(out[0, 0, 2 * blk:3 * blk].abs().max()) == 0.0


def test_path_choice_follows_the_main_path_shapes():
    cfg = get_config("qwen2-1.5b")
    hd, bq, bk = cfg.d_model // cfg.n_heads, cfg.hdp.block_q, cfg.hdp.block_k
    assert (hd, bq, bk) == (128, 128, 128)
    # the aligned prefill: bf16 model, bf16 V
    assert block_path(torch.bfloat16, hd, bq, bk) == "tensor_core"
    assert flash_path(torch.bfloat16, hd, bq, bk) == "tensor_core"
    assert block_path(torch.bfloat16, 64, 64, 128) == "tensor_core"
    assert flash_path(torch.bfloat16, 64, 64, 64) == "tensor_core"
    # the paged decode's densified route: fp32 V, block_q 8, block_k = ps
    assert block_path(torch.float32, hd, 8, 128) == "tile"
    # fp32 models and the reduced configs
    assert flash_path(torch.float32, hd, bq, bk) == "tile"
    assert block_path(torch.float32, hd, bq, bk) == "tile"
    assert block_path(torch.bfloat16, 8, 2, 2) == "tile"
    assert flash_path(torch.bfloat16, 8, 2, 2) == "tile"
    assert flash_path(torch.bfloat16, 16, 32, 16) == "tile"
    assert block_path(torch.bfloat16, 128, 32, 128) == "tile"


@pytest.mark.parametrize("fn,args", [
    (block_path, (torch.bfloat16, 256, 128, 128)),
    (block_path, (torch.float32, 130, 128, 128)),
    (block_path, (torch.bfloat16, 128, 256, 128)),
    (block_path, (torch.float32, 128, 8, 0)),
    (flash_path, (torch.bfloat16, 256, 128, 128)),
    (flash_path, (torch.float32, 6, 2, 2)),
    (flash_path, (torch.float32, 128, 129, 128)),
])
def test_shape_neither_path_takes_raises(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    q = grid((1, 1, 8, 16), 7, scale=2.0)
    v = torch.ones(1, 1, 8, 16)
    before = (dict(flash_attention.launches_by_path),
              dict(hdp_block_sparse_attention.launches_by_path))
    out = flash_attention(q, q, v, block_q=4, block_k=4)
    assert torch.equal(out, ref.flash_attention_plain(q, q, v, block_q=4,
                                                      block_k=4))
    idx = torch.zeros(1, 1, 2, 2, dtype=torch.int32)
    cnt = torch.ones(1, 1, 2, dtype=torch.int32)
    hdp_block_sparse_attention(q, q, v, idx, cnt, torch.ones(1, 1),
                               block_q=4, block_k=4)
    assert (flash_attention.launches_by_path,
            hdp_block_sparse_attention.launches_by_path) == before
