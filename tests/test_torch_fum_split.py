"""The FUM decode kernel's page split, on the CPU.

On the card the kernel splits each (b, n) row's listed pages over S
blocks (block s takes the listed pages s, s + S, ...), each block runs
the online softmax over its pages, and a merge pass combines the
partial states: m* = max m_s, out = Σ acc_s·e^(m_s−m*) /
max(Σ l_s·e^(m_s−m*), 1e-30). Here that merge, written in Python, is
applied to the plain version run on those page subsets
(``hdp_paged_fum_decode_ref(partial=True)``) and must give the unsplit
plain version within 1e-6 (fp32; only the order of the sums differs),
and the JAX kernel in interpret mode within its tests' 1e-5, also at
olmoe-1b-7b's MHA heads at the S its decode gets. NaN must survive the
merge as it survives one pass. ``fum_splits`` is a pure function of
shapes. The kernel itself runs only on the card
(``chip_smoke.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.hdp_paged_decode as jkern
from repro_torch.core.quant import pool_scale, quantize_fixed
from repro_torch.kernels.hdp_paged_decode import (MHA_FULL_CARD_SPLITS,
                                                  PATHS, fum_splits,
                                                  hdp_paged_fum_decode)
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

B, N, G, HD, PS, NP = 4, 2, 2, 8, 4, 8
P = 1 + B * NP
TOL = 1e-6
NAMES = ("qq", "k_pool", "v_pool", "page_ids", "logical", "counts", "keep",
         "kv_len")
#: olmoe-1b-7b's decode heads (MHA) and the S fum_splits gives its decode
#: (B 8, 16 page slots) on an H100's 132 SMs
OLMOE_HEADS = dict(N=16, G=1)
OLMOE_S = 2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def inputs(seed, Sq, quantized, N=N, G=G):
    """Kernel inputs the way stage 2 builds them, numpy from a seed: row 1
    lists no page, row 2 lists pages that no query row keeps, rows 0 and
    3 list about two thirds of their pages. ``N``, ``G``: kv heads and
    query heads a kv head (olmoe-1b-7b's MHA: N 16, G 1)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 2, (B, N, G, Sq, HD)).astype(np.float32)
    qq = np.asarray(quantize_fixed(_t(q)))
    if quantized:
        kp = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, PS, N, HD)).astype(np.int8)
        ks = np.full((P, N), pool_scale(4), np.float32)
        vs = ks.copy()
    else:
        kp = rng.normal(0, 4, (P, PS, N, HD)).astype(np.float32)
        vp = rng.normal(0, 1, (P, PS, N, HD)).astype(np.float32)
        ks = vs = None
    table = np.arange(1, P, dtype=np.int32).reshape(B, NP)
    fetched = rng.random((B, NP)) < 0.7
    fetched[1] = False
    fetched[[0, 2, 3], 0] = True
    keep = (rng.random((B, NP, N, G, Sq)) < 0.6) \
        & fetched[:, :, None, None, None]
    keep[2] = False
    page_ids = np.zeros((B, NP), np.int32)
    logical = np.zeros((B, NP), np.int32)
    keep_in = np.zeros((B, NP, N, G, Sq), np.int32)
    counts = fetched.sum(-1).astype(np.int32)
    for b in range(B):
        idx = np.nonzero(fetched[b])[0]
        logical[b, :len(idx)] = idx
        page_ids[b, :len(idx)] = table[b, idx]
        keep_in[b, :len(idx)] = keep[b, idx]
    kv_len = np.array([NP * PS - Sq + 1, 5, NP * PS // 2, NP * PS - Sq - 2],
                      np.int32)
    return dict(qq=qq, k_pool=kp, v_pool=vp, page_ids=page_ids,
                logical=logical, counts=counts, keep=keep_in, kv_len=kv_len,
                k_scale=ks, v_scale=vs)


def torch_args(d):
    kw = {k: (None if d[k] is None else _t(d[k]))
          for k in ("k_scale", "v_scale")}
    return tuple(_t(d[k]) for k in NAMES), kw


def subset(d, S, s):
    """The inputs block s of S sees: the listed pages s, s + S, ... below
    each row's count, compacted and padded with the scratch page 0."""
    out = dict(d)
    mk = d["page_ids"].shape[1]
    for name in ("page_ids", "logical", "keep"):
        out[name] = np.zeros_like(d[name])
    out["counts"] = np.zeros_like(d["counts"])
    for b in range(d["page_ids"].shape[0]):
        js = [j for j in range(min(int(d["counts"][b]), mk)) if j % S == s]
        out["counts"][b] = len(js)
        for name in ("page_ids", "logical", "keep"):
            out[name][b, :len(js)] = d[name][b, js]
    return out


def merged(d, S):
    """The plain version run on each block's pages, merged as the merge
    pass merges them."""
    parts = []
    for s in range(S):
        args, kw = torch_args(subset(d, S, s))
        parts.append(hdp_paged_fum_decode_ref(*args, **kw, partial=True))
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    w = torch.exp(m - m.amax(0))
    den = torch.clamp((l * w).sum(0), min=1e-30)
    return (acc * w[..., None]).sum(0) / den[..., None]


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp32"])
@pytest.mark.parametrize("Sq", [1, 3])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_merged_partials_equal_unsplit_plain(S, Sq, quantized):
    d = inputs(10 * S + Sq, Sq, quantized)
    args, kw = torch_args(d)
    want = hdp_paged_fum_decode_ref(*args, **kw)
    got = merged(d, S)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    # row 1 lists no page and row 2 keeps none: both give zeros, as in
    # one pass (l = 0 floored at 1e-30, acc = 0)
    assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp32"])
@pytest.mark.parametrize("Sq", [1, 3])
def test_merged_partials_match_jax_kernel(Sq, quantized):
    d = inputs(7 + Sq, Sq, quantized)
    jkw = {k: (None if d[k] is None else jnp.asarray(d[k]))
           for k in ("k_scale", "v_scale")}
    want = np.asarray(jkern.hdp_paged_fum_decode(
        *(jnp.asarray(d[k]) for k in NAMES), interpret=True, **jkw))
    np.testing.assert_allclose(merged(d, 3).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "fp32"])
@pytest.mark.parametrize("Sq", [1, 4])
def test_merged_partials_at_olmoe_heads(Sq, quantized):
    """olmoe-1b-7b's heads (N 16, G 1) at the S its decode gets, one query
    row (the decode step) and four (its verify at draft_len 4): the
    merged partials equal the unsplit plain version and the JAX kernel
    in interpret mode."""
    assert fum_splits(8, 16, 16, 132) == OLMOE_S
    d = inputs(70 + Sq, Sq, quantized, **OLMOE_HEADS)
    args, kw = torch_args(d)
    want = hdp_paged_fum_decode_ref(*args, **kw)
    got = merged(d, OLMOE_S)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert not got[1].any() and not got[2].any()
    jkw = {k: (None if d[k] is None else jnp.asarray(d[k]))
           for k in ("k_scale", "v_scale")}
    ref = np.asarray(jkern.hdp_paged_fum_decode(
        *(jnp.asarray(d[k]) for k in NAMES), interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("G,mk,want", [(1, 16, MHA_FULL_CARD_SPLITS),
                                       (1, 1, 1), (4, 16, 1), (6, 16, 1)])
def test_fum_splits_of_rows_that_fill_the_card(G, mk, want):
    """B*N in (n_sm / 2, n_sm]: an MHA shape (G 1) takes two blocks a row
    (a one-row block fits two to an SM), a GQA shape one pass; rows past
    the card take one pass and fewer rows about one block per SM, at any
    G."""
    assert MHA_FULL_CARD_SPLITS == OLMOE_S
    assert fum_splits(8, 16, mk, 132, G) == want
    assert fum_splits(9, 16, mk, 132, G) == 1          # 144 rows
    assert fum_splits(4, 16, mk, 132, G) == min(mk, 2)   # 132 // 64


@pytest.mark.parametrize("S", [1, 3, 8])
def test_nan_on_a_listed_page_no_row_keeps_survives_the_merge(S):
    """Every listed page is read for every kv head: a NaN V scale on a
    listed page whose keep is 0 for every query row still gives NaN
    (p = 0 times NaN), unsplit and merged alike."""
    d = inputs(5, 1, True)
    b, j = 0, 1
    d["keep"][b, j] = 0
    d["v_scale"] = d["v_scale"].copy()
    d["v_scale"][d["page_ids"][b, j]] = np.nan
    args, kw = torch_args(d)
    want = hdp_paged_fum_decode_ref(*args, **kw)
    got = merged(d, S)
    assert torch.isnan(want[b]).all() and torch.isnan(got[b]).all()
    others = [r for r in range(B) if r != b]
    torch.testing.assert_close(got[others], want[others], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B_,N_,mk,n_sm,want", [
    (8, 2, 9, 132, 8),       # qwen2-1.5b serving: one block per SM
    (8, 2, 16, 132, 8),      # the timing case
    (1, 2, 16, 132, 16),     # at most one block per page slot
    (1, 2, 100, 132, 66),
    (70, 2, 9, 132, 1),      # more rows than SMs: one pass
    (4, 2, 0, 132, 1),       # no page slot
    (2, 1, 5, 4, 2),
    (8, 16, 16, 132, OLMOE_S),   # olmoe-1b-7b's decode (MHA): 128 rows
])
def test_fum_splits_is_a_function_of_shapes(B_, N_, mk, n_sm, want):
    assert fum_splits(B_, N_, mk, n_sm) == want
    assert fum_splits(B_, N_, mk, n_sm) == want     # no hidden state
    assert 1 <= want <= max(1, mk)


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    d = inputs(3, 3, True)
    args, kw = torch_args(d)
    before = dict(hdp_paged_fum_decode.launches_by_path)
    n = hdp_paged_fum_decode.launches
    want = hdp_paged_fum_decode_ref(*args, **kw)
    for splits in (None, 1, 3):
        assert torch.equal(hdp_paged_fum_decode(*args, **kw, splits=splits),
                           want)
    assert hdp_paged_fum_decode.launches == n
    assert hdp_paged_fum_decode.launches_by_path == before
    assert tuple(before) == PATHS == ("single", "split")
    with pytest.raises(ValueError, match="splits"):
        hdp_paged_fum_decode(*args, **kw, splits=0)


def test_cpu_calls_count_no_run_on_the_card():
    # the kernel's own run counter lives on the card: a CPU call (the
    # plain version) neither makes one nor adds to it
    d = inputs(3, 3, True)
    args, kw = torch_args(d)
    made = dict(hdp_paged_fum_decode.runs._on)
    hdp_paged_fum_decode(*args, **kw)
    assert hdp_paged_fum_decode.runs._on == made
    assert hdp_paged_fum_decode.runs.read() == sum(
        int(t.item()) for t in made.values())
