"""Port parity of self-speculative decode on reduced qwen2-1.5b (CPU,
plain kernel versions).

The port of ``tests/test_spec_decode.py``:

* speculative decode gives the tokens of horizon-1 greedy decode, paged
  and dense, at draft lengths 1, 3, 4 and 8 with staggered budgets, and
  the JAX engine's tokens at each draft length (paged); with HDP off
  (acceptance 1.0), with EOS mid-round, and with a draft that is almost
  never accepted;
* the env defaults, the calibration pin, and the counters, which count
  only slots that decoded;
* the draft never reads the K pool (a NaN pool changes nothing), and the
  scout draft requires the fraction pool;
* a multi-query verify row equals the sequential single step at its
  position (2e-5) on every stage 3; the FUM kernel's plain version at
  G*Sq = 48 equals the JAX kernel in interpret mode;
* the verify call resolves through the registry to the backends that
  take it, the draft call never to a kernel;
* rejected speculative writes are poisoned (pool bytes equal to the JAX
  engine's after a speculative serve, -128 codes included), rollback
  respects COW and the write floor, and speculation composes with the
  prefix cache;
* the round body reads nothing back to the host (what lets a CUDA graph
  hold it), the verify is the round's only decode-kernel call, and a
  graphed engine keeps one graph per round width.

``test_spec_round_donates_cache`` has no counterpart: the reference
donates its pool to the jitted round and guards stale handles with
``DonatedCacheError``, while the port updates its pool in place.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.config import HDPConfig as JHDPConfig
from repro.kernels.hdp_paged_decode import hdp_paged_fum_decode as j_fum
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import (AttnSpec, DraftProfile, get_backend,
                                   resolve_backend)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.config import HDPConfig
from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
from repro_torch.models import attention as A
from repro_torch.models import registry
from repro_torch.models.attention import (_fetch_list, build_attn_call,
                                          hdp_paged_decode_attention,
                                          scout_frac_int8, scout_int8)
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

#: a draft whose head gate kills every head: its proposals degenerate to
#: a constant token, so almost every round rejects almost everything
DEAD_DRAFT = DraftProfile(tau_h=1e9)
KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
DRAFT_LENS = (1, 3, 4, 8)


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


PROMPTS = _prompts(4, seed=3)


def _qwen(enabled=True, calib="none"):
    cfg = reduced(get_config("qwen2-1.5b"))
    return cfg.replace(hdp=cfg.hdp.replace(enabled=enabled, calib=calib))


def _budget(uid: int, stagger: bool = True) -> int:
    return 5 + (uid % 3 if stagger else 0)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def weights():
    """One set of seeded weights as the JAX tree and the port's dict."""
    tree = _numpy_tree(registry.init_params(_qwen(), 0, "cpu"))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(_qwen(), tree, "cpu"))


def _serve(params, prompts=PROMPTS, *, cfg=None, stagger=True, eos=None,
           **kw):
    eng = Engine(cfg or _qwen(), params, device="cpu", **{**KW, **kw})
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=_budget(uid, stagger),
                           eos_id=eos))
    return eng, {u: r.tokens for u, r in eng.run().items()}


@pytest.fixture(scope="module")
def base(weights):
    return _serve(weights[1], spec_decode=False, decode_horizon=1)[1]


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine's tokens and counters at each draft length, and its
    pool after the first run (draft length 4, on a fresh pool). One
    engine serves them all in turn (``spec`` and ``draft_len`` are all
    that its arguments set), so its prefill compilation is shared."""
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jeng = JEngine(jcfg.replace(hdp=jcfg.hdp.replace(calib="none")),
                   params=weights[0],
                   attn=JSpec(backend="xla", kv_dtype="int8"),
                   decode_horizon=1, prefix_cache=False, spec_decode=False,
                   stream_sched=False, **KW)
    runs = {}
    for k in (4, 1, 3, 8):
        jeng.spec = True
        jeng.draft_len = k
        jeng.reset_metrics()
        for uid, p in enumerate(PROMPTS):
            jeng.submit(JRequest(uid, p, max_new_tokens=_budget(uid)))
        runs[k] = ({u: r.tokens for u, r in jeng.run().items()},
                   dict(jeng.metrics))
        if k == 4:
            runs["pool"] = {n: np.asarray(x)
                            for n, x in jeng.pages.cache.items()}
    return runs


# ------------------------------------------------------------ token identity
@pytest.mark.parametrize("k", DRAFT_LENS)
@pytest.mark.parametrize("layout", [
    "paged",
    pytest.param("dense", marks=pytest.mark.slow),
])
def test_spec_matches_single_step(weights, base, layout, k):
    """Staggered budgets: slots finish mid-round while their neighbours
    keep speculating, and the output must not notice."""
    attn = AttnSpec(layout=layout)
    _, ref = _serve(weights[1], spec_decode=False, attn=attn) \
        if layout == "dense" else (None, base)
    eng, got = _serve(weights[1], spec_decode=True, draft_len=k, attn=attn)
    assert got == ref, f"{layout} draft_len={k}: {got} != {ref}"
    assert eng.summary()["spec_rounds"] > 0
    if layout == "paged":
        eng.pages.allocator.assert_drained()


@pytest.mark.parametrize("k", DRAFT_LENS)
def test_spec_matches_jax_engine(weights, base, jax_runs, k):
    """The port's speculative tokens and counters equal the JAX engine's
    at the same draft length, and both equal horizon 1. At draft length
    4 the pool bytes after the serve equal the JAX pool's too: the
    staged and rewritten K/V, and the -128 codes of the rejected
    positions that no later write reached."""
    jtok, jm = jax_runs[k]
    eng, tok = _serve(weights[1], spec_decode=True, draft_len=k)
    assert tok == jtok == base
    for key in ("spec_rounds", "draft_tokens", "accepted_tokens",
                "tokens_out", "decode_steps", "prefill_calls"):
        assert eng.metrics[key] == jm[key], key
    if k == 4:
        assert bool((eng.pages.cache["k_pages"] == -128).any()), \
            "no rolled-back position left in the pool"
        for name, leaf in eng.pages.cache.items():
            # page 0 is the scratch page: redirected writes land there in
            # an unspecified order
            np.testing.assert_array_equal(
                leaf[:, 1:].numpy(), jax_runs["pool"][name][:, 1:],
                err_msg=name)


def test_spec_matches_single_step_no_hdp(weights):
    """HDP off: no scout to draft with, so the draft degrades to an exact
    proposer, fully accepted under greedy decode (a lower rate would mean
    the draft reads state the staging skipped)."""
    cfg = _qwen(enabled=False)
    prompts = _prompts(3, seed=5)
    _, ref = _serve(weights[1], prompts, cfg=cfg, spec_decode=False,
                    stagger=False)
    eng, got = _serve(weights[1], prompts, cfg=cfg, spec_decode=True,
                      draft_len=4, stagger=False)
    assert got == ref
    assert eng.summary()["acceptance_rate"] == 1.0


def test_eos_mid_round_matches_single_step(weights):
    prompt = _prompts(1, seed=2)[0]
    _, ref = _serve(weights[1], [prompt], stagger=False, max_batch=1,
                    spec_decode=False)
    ref = ref[0]
    j = next((i for i in range(1, len(ref)) if ref[i] not in ref[:i]), None)
    assert j is not None, f"degenerate generation {ref}"
    for k in (2, 4, 8):
        _, got = _serve(weights[1], [prompt], stagger=False, max_batch=1,
                        spec_decode=True, draft_len=k, eos=ref[j])
        assert got[0] == ref[:j + 1], f"draft_len={k}"


def test_zero_acceptance_rounds_still_identical(weights, base):
    """A draft whose proposals are almost never accepted costs speed,
    never correctness: every committed token is the verify's."""
    eng, got = _serve(weights[1], spec_decode=True, draft_len=4,
                      draft_profile=DEAD_DRAFT)
    assert got == base
    s = eng.summary()
    assert s["acceptance_rate"] < 0.5 and s["spec_rounds"] > 0


# -------------------------------------------------------------- env plumbing
def test_spec_env_defaults(monkeypatch, weights):
    monkeypatch.setenv("REPRO_SPEC_DECODE", "1")
    monkeypatch.setenv("REPRO_DRAFT_LEN", "3")
    kw = dict(max_batch=1, max_len=32)
    eng = Engine(_qwen(), weights[1], device="cpu", **kw)
    assert eng.spec and eng.draft_len == 3
    # explicit arguments win over the env
    eng = Engine(_qwen(), weights[1], device="cpu", spec_decode=False,
                 draft_len=5, **kw)
    assert not eng.spec and eng.draft_len == 5
    with pytest.raises(ValueError, match="draft_len"):
        Engine(_qwen(), weights[1], device="cpu", spec_decode=True,
               draft_len=0, **kw)


def test_spec_pins_static_calibration(weights):
    """Staging leaves garbage past the frontier, which a data-dependent
    calibration would see: a speculating engine pins the static grid on
    every layout, as the paged pool's write-time scout does."""
    eng = Engine(_qwen(calib="max"), weights[1], device="cpu", max_batch=1,
                 max_len=32, attn=AttnSpec(layout="dense"), spec_decode=True)
    assert eng.cfg.hdp.calib == "none"
    eng = Engine(_qwen(calib="max"), weights[1], device="cpu", max_batch=1,
                 max_len=32, attn=AttnSpec(layout="dense"))
    assert eng.cfg.hdp.calib == "max"


# ------------------------------------------------------------------ counters
def test_spec_counters_masked_for_parked_slots(weights):
    """One request on a 2-slot engine: the parked slot inflates no
    count, and the counters match the emitted tokens exactly."""
    eng = Engine(_qwen(), weights[1], device="cpu", spec_decode=True,
                 draft_len=4, **KW)
    eng.submit(Request(0, _prompts(1, seed=9)[0], max_new_tokens=7))
    res = eng.run()
    s = eng.summary()
    assert len(res[0].tokens) == 7
    assert s["spec_decode"] and s["draft_len"] == 4
    assert 0 < s["draft_tokens"] <= 3 * s["spec_rounds"]
    # every round commits >= 1 exact token; the rest are accepted drafts
    assert s["tokens_out"] == s["accepted_tokens"] + s["spec_rounds"]
    assert 0.0 <= s["acceptance_rate"] <= 1.0
    assert s["attn_backend_draft"] == "paged_hdp_decode"
    assert s["attn_backend_verify"] == "pallas_paged_decode"
    assert s["attn_verify_stage3"] == "plain:hdp_paged_fum_decode_ref"


# -------------------------------------------------- draft bandwidth contract
def _paged_inputs(seed, n_pages, B=2, N=2, G=2, hd=8, Sq=1, ps=4):
    """Seeded paged-decode inputs as numpy: q, the K and V pools, the
    table, and the positions of Sq consecutive query rows ending at the
    last page's end."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pages
    q = rng.standard_normal((B, N, G, Sq, hd)).astype(np.float32)
    ks = rng.standard_normal((P, ps, N, hd)).astype(np.float32)
    vs = rng.standard_normal((P, ps, N, hd)).astype(np.float32)
    table = np.arange(1, P, dtype=np.int32).reshape(B, n_pages)
    pos = n_pages * ps - Sq + np.arange(Sq, dtype=np.int32)[None] \
        * np.ones((B, 1), np.int32)
    ar = np.arange(n_pages * ps)
    k_pos = np.where(ar[None] <= pos[:, -1:], ar, -1)[:, None, None, :]
    return q, ks, vs, table, pos[:, None, None, :], k_pos


def _hdp(ps=4):
    kw = dict(block_q=1, block_k=ps, rho_b=0.5, causal=True,
              head_pruning=False, calib="none")
    return HDPConfig(**kw), JHDPConfig(**kw)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_draft_never_reads_fp_k_pool():
    """The scout-score draft reads only the int8 copies and the surviving
    V: a NaN K pool changes nothing, on the unquantized and the int8
    pool (the engine tests hold the drafts' proposals against the JAX
    engine's through its acceptance counters)."""
    hdp, _ = _hdp()
    q, ks, vs, table, q_pos, k_pos = _paged_inputs(0, n_pages=6)
    tq, tks, tvs, ttab, tqp, tkp = _t(q, ks, vs, table, q_pos, k_pos)
    ik, fk = scout_int8(tks, hdp), scout_frac_int8(tks, hdp)
    for profile in (DraftProfile(), DraftProfile(scores="int")):
        kw = dict(q_pos=tqp, k_pos=tkp, hdp=hdp, draft=profile, fk_pool=fk)
        clean, _ = hdp_paged_decode_attention(tq, tks, tvs, ik, ttab, **kw)
        poisoned, _ = hdp_paged_decode_attention(
            tq, torch.full_like(tks, float("nan")), tvs, ik, ttab, **kw)
        assert bool(torch.isfinite(poisoned).all()), \
            f"{profile.scores}: the draft read the K pool"
        assert torch.equal(clean, poisoned)
    # an int8 pool derives both copies from its codes: a NaN scale (the
    # stage-3 poison) cannot reach the draft either
    codes = torch.clamp(torch.round(tks / 0.125), -127, 127).to(torch.int8)
    vcodes = torch.clamp(torch.round(tvs / 0.125), -127, 127).to(torch.int8)
    s = torch.full((codes.shape[0], codes.shape[2]), 0.125)
    kw = dict(q_pos=tqp, k_pos=tkp, hdp=hdp, draft=DraftProfile(),
              v_scale=s)
    clean, _ = hdp_paged_decode_attention(tq, codes, vcodes, None, ttab,
                                          k_scale=s, **kw)
    poisoned, _ = hdp_paged_decode_attention(
        tq, codes, vcodes, None, ttab, k_scale=torch.full_like(s, float("nan")),
        **kw)
    assert torch.equal(clean, poisoned)


def test_scout_draft_requires_frac_pool():
    """Without the f_scout pool the scout draft's IQ.FK^ term would need
    the K pool: the misuse raises instead of drafting worse."""
    hdp, _ = _hdp()
    q, ks, vs, table, q_pos, k_pos = _t(*_paged_inputs(2, n_pages=4))
    with pytest.raises(ValueError, match="f_scout"):
        hdp_paged_decode_attention(q, ks, vs, scout_int8(ks, hdp), table,
                                   q_pos=q_pos, k_pos=k_pos, hdp=hdp,
                                   draft=DraftProfile())


# --------------------------------------------------- per-query verify scout
@pytest.mark.parametrize("stage3", ["xla", "pallas_paged", "pallas_block"])
def test_verify_rows_match_sequential_steps(stage3):
    """Row j of a multi-query verify call equals the single step at
    position j (keep masks, head gates and softmax alike); the densifying
    block stage falls back to "xla" for a per-query call, as in the
    reference."""
    hdp, _ = _hdp()
    Sq = 3
    q, ks, vs, table, q_pos, k_pos = _paged_inputs(4, n_pages=4, Sq=Sq)
    tq, tks, tvs, ttab, tqp, tkp = _t(q, ks, vs, table, q_pos, k_pos)
    ik = scout_int8(tks, hdp)
    multi, _ = hdp_paged_decode_attention(
        tq, tks, tvs, ik, ttab, q_pos=tqp, k_pos=tkp, hdp=hdp,
        per_query=True, stage3=stage3)
    for j in range(Sq):
        pj = tqp[..., j:j + 1]
        ar = torch.arange(tkp.shape[-1])
        kj = torch.where(ar[None, None, None, :] <= pj, ar, -1)
        single, _ = hdp_paged_decode_attention(
            tq[:, :, :, j:j + 1], tks, tvs, ik, ttab, q_pos=pj, k_pos=kj,
            hdp=hdp, stage3=stage3)
        np.testing.assert_allclose(
            multi[:, :, :, j].numpy(), single[:, :, :, 0].numpy(),
            atol=2e-5, rtol=2e-5,
            err_msg=f"{stage3}: verify row {j} != sequential step")


def test_fum_plain_at_48_rows_matches_jax():
    """The FUM wrapper's plain version at G*Sq = 48 (qwen2-1.5b's G = 6 at
    draft length 8, past the kernel's former 32-row limit) equals the JAX
    kernel in interpret mode on the same page lists, on an int8 pool."""
    B, N, G, Sq, hd, ps, nP = 2, 2, 6, 8, 8, 4, 5
    P = 1 + B * nP
    rng = np.random.default_rng(8)
    qq = np.round(rng.standard_normal((B, N, G, Sq, hd)) * 2 * 4096) / 4096
    kp = rng.integers(-127, 128, (P, ps, N, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (P, ps, N, hd)).astype(np.int8)
    sc = np.full((P, N), 0.125, np.float32)
    table = np.arange(1, P, dtype=np.int32).reshape(B, nP)
    keep = rng.random((B, N, G, Sq, nP)) < 0.5
    q_pos = (nP * ps - Sq + np.arange(Sq))[None, None, None, :] \
        * np.ones((B, 1, 1, 1), np.int64)
    lists = _fetch_list(torch.from_numpy(keep.any(axis=(1, 2, 3))),
                        torch.from_numpy(table), torch.from_numpy(keep),
                        torch.from_numpy(q_pos))
    tq = torch.from_numpy(qq.astype(np.float32))
    got = hdp_paged_fum_decode(tq, torch.from_numpy(kp), torch.from_numpy(vp),
                               *lists, k_scale=torch.from_numpy(sc),
                               v_scale=torch.from_numpy(sc))
    assert got.shape == (B, N, G, Sq, hd) and bool(torch.isfinite(got).all())
    ref = hdp_paged_fum_decode_ref(tq, torch.from_numpy(kp),
                                   torch.from_numpy(vp), *lists,
                                   k_scale=torch.from_numpy(sc),
                                   v_scale=torch.from_numpy(sc))
    assert torch.equal(got, ref)
    jl = [jnp.asarray(x.numpy()) for x in lists]
    want = j_fum(jnp.asarray(qq.astype(np.float32)), jnp.asarray(kp),
                 jnp.asarray(vp), *jl, k_scale=jnp.asarray(sc),
                 v_scale=jnp.asarray(sc), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_verify_call_resolves_through_registry():
    """The verify call resolves to the backends that take multi-query
    calls (the FUM kernel first, as the reference ranks it on the TPU);
    the draft call never lands on a kernel."""
    cfg = _qwen()
    ver = build_attn_call(cfg, mode="decode", paged=True, per_slot=True,
                          verify=True)
    assert get_backend("paged_hdp_decode").supports(ver)
    assert get_backend("pallas_paged_decode").supports(ver)
    assert not get_backend("pallas_hdp_block").supports(ver)
    assert resolve_backend(ver, AttnSpec()).name == "pallas_paged_decode"
    assert resolve_backend(ver, AttnSpec(backend="xla")).name \
        == "paged_hdp_decode"
    drf = build_attn_call(cfg, mode="decode", paged=True, per_slot=True,
                          draft=DEAD_DRAFT)
    assert drf.hdp.tau_h == 1e9          # the profile's overlay
    assert not get_backend("pallas_paged_decode").supports(drf)
    assert resolve_backend(drf, AttnSpec(backend="pallas")).name \
        == "paged_hdp_decode"            # kernels fall back for drafts
    dense = build_attn_call(cfg, mode="decode", per_slot=True,
                            draft=DraftProfile())
    assert resolve_backend(dense, AttnSpec()).name == "xla_hdp"


# --------------------------------------------------------- rollback + poison
@pytest.mark.parametrize("pool", ["int8", "fp32"])
def test_rejected_speculative_writes_are_poisoned(weights, pool):
    """After a round with rejections the K of every rejected staged
    position is poisoned (NaN in the fp32 pool, -128 in the int8 one),
    the committed frontier is not, and generation drains to horizon 1's
    tokens through the poison (rewrite before read holds)."""
    prompt = _prompts(1, seed=13)[0]
    attn = AttnSpec(kv_dtype=pool)
    kw = dict(max_batch=1, max_len=64)
    ref = Engine(_qwen(), weights[1], device="cpu", spec_decode=False,
                 attn=attn, **kw)
    ref.submit(Request(0, prompt, max_new_tokens=8))
    ref = ref.run()[0].tokens
    k = 4
    eng = Engine(_qwen(), weights[1], device="cpu", spec_decode=True,
                 draft_len=k, draft_profile=DEAD_DRAFT, attn=attn, **kw)
    eng.submit(Request(0, prompt, max_new_tokens=8))
    start = len(prompt) - 1
    eng.step()                              # admit + the first round
    committed = len(eng._active[0]["generated"])
    assert committed < k, "the dead draft was fully accepted"
    ps = eng.pages.page_size
    pages = eng.pages.slot_pages(0)
    poisoned = eng.pages.poison_view()
    for p in range(start + committed, start + k):
        page, off = pages[p // ps], p % ps
        assert poisoned[:, page, off].all(), \
            f"rejected staged position {p} not poisoned"
    last = start + committed - 1
    assert not poisoned[:, pages[last // ps], last % ps].any()
    assert eng.run()[0].tokens == ref


def test_spec_rollback_respects_cow_and_write_floor(weights):
    """Full-prompt prefix hit: the resume and the staging land in the
    COW'd tail page; the shared original's bytes never change while
    rounds stage and roll back across it."""
    rng = np.random.default_rng(11)
    donor = rng.integers(1, 250, size=13).tolist()
    kw = dict(max_batch=1, max_len=64, prefill_buckets=(16, 32))
    eng = Engine(_qwen(), weights[1], device="cpu", prefix_cache=True,
                 spec_decode=True, draft_len=4, **kw)
    eng.submit(Request(0, donor, max_new_tokens=3))
    eng.run()
    matched = eng.prefix.match(donor[:12])
    tail_page = matched[-1]
    eng.pages.allocator.unref(matched)
    before = eng.pages.cache["k_pages"][:, tail_page].clone()

    eng.submit(Request(1, donor[:12], max_new_tokens=3))   # full hit -> COW
    res = eng.run()
    assert eng.summary()["cow_copies"] == 1
    assert torch.equal(before, eng.pages.cache["k_pages"][:, tail_page])

    solo = Engine(_qwen(), weights[1], device="cpu", prefix_cache=False,
                  spec_decode=False, **kw)
    solo.submit(Request(9, donor[:12], max_new_tokens=3))
    assert res[1].tokens == solo.run()[9].tokens


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_prefix_cache_identity(weights, prefix_cache):
    """Shared-prefix traffic: speculative decode with the prefix cache
    on or off gives the non-speculative engine's tokens."""
    rng = np.random.default_rng(17)
    shared = rng.integers(1, 250, size=16).tolist()
    prompts = [shared + rng.integers(1, 250, size=4 + i).tolist()
               for i in range(3)] + [shared[:12]]
    outs = []
    for spec in (False, True):
        eng = Engine(_qwen(), weights[1], device="cpu", max_batch=2,
                     max_len=96, prefill_buckets=(16, 32),
                     prefix_cache=prefix_cache, spec_decode=spec,
                     draft_len=4)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=4))
        outs.append({u: r.tokens for u, r in eng.run().items()})
    assert outs[0] == outs[1]


# ------------------------------------------------- the round on the device
class _NoHostRead(TorchDispatchMode):
    """Raises on any op that reads a device value back to the host or
    makes a tensor from host data."""
    FORBIDDEN = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
                 torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.FORBIDDEN:
            raise AssertionError(f"host read in the round: {func}")
        return func(*args, **(kwargs or {}))


def _opaque(kernel):
    """The wrapper outside the dispatch mode: on the card one launch, on
    the CPU its plain version, which walks the page lists on the host."""
    def call(*args, **kw):
        with _disable_current_modes():
            return kernel(*args, **kw)
    return call


ROUND_ROUTES = [None, AttnSpec(kv_dtype="fp32"), AttnSpec(kv_dtype="fp8_v"),
                AttnSpec(layout="dense")]


@pytest.mark.parametrize("attn", ROUND_ROUTES,
                         ids=["int8", "fp32", "fp8_v", "dense"])
def test_spec_body_reads_nothing_back(weights, attn, monkeypatch):
    monkeypatch.setattr(A, "hdp_paged_fum_decode",
                        _opaque(hdp_paged_fum_decode))
    eng = Engine(_qwen(), weights[1], device="cpu", collect_stats=True,
                 spec_decode=True, draft_len=4, attn=attn, **KW)
    prompt = PROMPTS[0]
    eng.submit(Request(0, prompt, max_new_tokens=6))
    eng._admit()
    with _NoHostRead():
        eng._spec_body(4)
    com = eng._hist[:4, 1, 0]
    n = int(com.sum())
    assert n >= 1 and com[:n].all() and not eng._hist[:4, 1, 1].any()
    assert int(eng._pos[0]) == len(prompt) - 1 + n
    assert int(eng._rem[0]) == 6 - n
    assert bool(torch.isfinite(eng._hist_stats[0]).all())


def test_verify_is_the_rounds_only_kernel_call(weights, base, monkeypatch):
    """Counted as a wrapper counts its launches on the card: each round's
    verify calls the FUM kernel once per layer at Sq = k, and its draft
    steps never do."""
    calls = []

    def counting(*args, **kw):
        calls.append(args[0].shape[3])
        hdp_paged_fum_decode.launches += 1
        return hdp_paged_fum_decode(*args, **kw)

    monkeypatch.setattr(A, "hdp_paged_fum_decode", counting)
    monkeypatch.setattr(hdp_paged_fum_decode, "launches",
                        hdp_paged_fum_decode.launches)
    eng, tok = _serve(weights[1], spec_decode=True, draft_len=4)
    assert tok == base
    n_layers = _qwen().n_layers
    assert eng.round_launches, "no round recorded its launches"
    for k, rl in eng.round_launches.items():
        assert rl["draft"]["fum_kernel_launches"] == 0
        assert rl["verify"]["fum_kernel_launches"] == n_layers
    s = eng.summary()
    assert s["fum_kernel_launches"] == n_layers * s["spec_rounds"]
    # round_launches is keyed by (k, draft profile tier)
    assert set(calls) == {k for k, _ in eng.round_launches}


class _EagerGraph:
    """Stands in for a captured CUDA graph: replay runs the body."""

    def __init__(self, body):
        self.replay = body


def test_one_graph_per_round_width(weights, base):
    """A graphed engine captures a round's graph at the first round of
    each width k (the draft length clamped to the longest remaining
    budget), at most draft_len of them, and adds what each replay
    launches to its counts."""
    n_layers = _qwen().n_layers
    eng = Engine(_qwen(), weights[1], device="cpu", spec_decode=True,
                 draft_len=4, **KW)
    eng.cuda_graph = True
    widths = []

    def capture(body, width):
        widths.append(width)
        return _EagerGraph(body), {"fum_kernel_launches": n_layers,
                                   "block_kernel_launches": 0}

    eng._capture = capture
    for uid, p in enumerate(PROMPTS):
        eng.submit(Request(uid, p, max_new_tokens=_budget(uid)))
    assert {u: r.tokens for u, r in eng.run().items()} == base
    s = eng.summary()
    assert widths and len(widths) == len(set(widths)) <= 4
    # keyed (k, tier): a fixed draft profile is the "base" tier, and
    # k = 1 drafts nothing, so has no tier
    assert set(eng._graphs) == {(w, "base") if w > 1 else (1, None)
                                for w in widths}
    assert s["spec_graphs"] == len(widths)
    assert s["fum_kernel_launches"] == n_layers * s["spec_rounds"]
