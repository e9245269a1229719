"""Port parity of the refcounted page allocator and the radix prefix
cache on reduced qwen2-1.5b (CPU, plain kernel versions).

The port of ``tests/test_prefix_cache.py``, run on the int8 pool and on
the model-dtype ("fp32") pool where the reference runs a pool:

* allocator refcounts (last-unref frees, double free raises, freed
  pages return to the front) and the radix tree (match, insert, LRU
  eviction that skips pinned leaves, match alignment trimmed before
  counting);
* a prefix hit gives the cold engine's tokens, the dense layout's on
  the fp32 pool, and the JAX engine's (suffix hits, full hits with their
  COW, and a long prompt hit through chunked prefill);
* every page's refcount equals its slot owners plus its prefix-cache
  residency under interleaved submit and finish;
* COW keeps the donor's cached page bytes, the write floor fences shared
  pages, eviction under pressure keeps serving, a hit unwinds on pool
  exhaustion or falls back to cold, and exhaustion raises when nothing
  is evictable;
* poison lands on the last unref only; parked slots are masked from the
  stats, and decode stats are per slot;
* pool bytes equal the JAX pool's after ``cow`` and ``gather_prefix``
  on every pool format;
* the layout requirement and the REPRO_PREFIX_CACHE default.

``test_batched_prefill_donates_pool`` has no counterpart: the reference
donates its pool to a jitted prefill and guards stale handles with
``DonatedCacheError``, while the port updates its pool in place, so no
handle goes stale and there is nothing to guard.
"""
from __future__ import annotations

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import registry
from repro_torch.serving import (Engine, PageAllocator, RadixPrefixCache,
                                 Request)
from repro_torch.serving.kv_cache import PagedKVCache

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

F8 = torch.float8_e4m3fn
#: the pools the serving tests run on: the int8 default and the
#: model-dtype pool with its int8 scout copy
POOLS = ["int8", "fp32"]


def _qwen(head_pruning=False):
    """The reference's identity tests switch the head gate off: it is a
    whole-forward decision, so prefill hidden states are prefix-causal
    only while its decisions agree."""
    cfg = reduced(get_config("qwen2-1.5b"))
    return cfg.replace(hdp=cfg.hdp.replace(calib="none",
                                           head_pruning=head_pruning))


def _jqwen():
    cfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    return cfg.replace(hdp=cfg.hdp.replace(calib="none", head_pruning=False))


def _shared_prompts(n_tail=3, prefix_len=20, seed=0, vocab=250):
    """Prompts sharing a page-aligned prefix, plus aligned sub-prefix
    prompts (full hits)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=prefix_len).tolist()
    prompts = [shared + rng.integers(1, vocab, size=5 + i).tolist()
               for i in range(n_tail)]
    prompts.append(shared[:6])
    prompts.append(shared[:12])
    return prompts


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


def _engine(params, cfg=None, **kw):
    kw = {"max_batch": 2, "max_len": 64, "prefill_buckets": (16, 32), **kw}
    return Engine(cfg or _qwen(), params, device="cpu", **kw)


def _serve(params, prompts, *, prefix, max_new=4, **kw):
    eng = _engine(params, prefix_cache=prefix, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=max_new))
    return eng, {u: r.tokens for u, r in eng.run().items()}


@pytest.fixture(scope="module")
def jax_hot(weights):
    """The JAX engine's prefix-hit tokens for ``_shared_prompts`` on each
    pool (one engine per pool; the XLA backends)."""
    out = {}
    for pool in POOLS:
        jeng = JEngine(_jqwen(), params=weights[0], max_batch=2, max_len=64,
                       prefill_buckets=(16, 32), prefix_cache=True,
                       attn=JSpec(backend="xla", kv_dtype=pool),
                       spec_decode=False, stream_sched=False)
        for uid, p in enumerate(_shared_prompts()):
            jeng.submit(JRequest(uid, p, max_new_tokens=4))
        out[pool] = ({u: r.tokens for u, r in jeng.run().items()},
                     jeng.summary())
    return out


# ------------------------------------------------------------- allocator unit
def test_allocator_refcount_lifecycle():
    al = PageAllocator(8, reserved=1)
    assert al.capacity == 7 and al.available == 7 and al.in_use == 0
    a = al.alloc(3)
    assert 0 not in a and al.in_use == 3
    al.ref([a[0]])                       # second owner
    assert al.refcount(a[0]) == 2
    freed = al.unref(a)                  # drop the first owner of all three
    assert freed == a[1:] and al.in_use == 1
    assert al.refcount(a[0]) == 1
    assert al.unref([a[0]]) == [a[0]]    # last unref -> true free
    assert al.available == 7 and al.in_use == 0
    with pytest.raises(ValueError):
        al.unref([a[0]])                 # double free
    with pytest.raises(ValueError):
        al.ref([a[0]])                   # ref of a free page
    with pytest.raises(RuntimeError):
        al.alloc(8)                      # beyond capacity
    # freed pages return to the FRONT: deterministic hot reuse
    assert al.alloc(2) == a[:2]


def test_radix_match_insert_lru():
    al = PageAllocator(16, reserved=1)
    tree = RadixPrefixCache(al, page_size=2)
    toks = [1, 2, 3, 4, 5, 6]
    pages = al.alloc(3)
    assert tree.insert(toks, pages) == 3
    assert tree.cached_pages == 3
    assert [al.refcount(p) for p in pages] == [2, 2, 2]
    al.unref(pages)                      # the original owner retires
    m = tree.match([1, 2, 3, 4, 9, 9])   # partial: two chunks
    assert m == pages[:2] and al.refcount(pages[0]) == 2
    assert tree.peek([1, 2, 3, 4, 9, 9]) == 2 and tree.hits == 1
    al.unref(m)
    assert tree.match([7, 7]) == [] and tree.misses == 1
    assert tree.evictable_pages() == 3
    # LRU: the matched path was bumped; the unmatched tail evicts first
    assert tree.evict(1) == 1
    assert tree.cached_pages == 2 and al.refcount(pages[2]) == 0
    # pinned leaves (slot-referenced) are skipped
    m = tree.match([1, 2, 3, 4])
    assert tree.evict(4) == 0 and tree.evictable_pages() == 0
    al.unref(m)
    assert tree.evict(4) == 2 and tree.cached_pages == 0
    assert al.in_use == 0
    with pytest.raises(ValueError, match="reserved"):
        tree.insert([1, 2], [0])


def test_match_alignment_trims_before_counting():
    al = PageAllocator(16, reserved=1)
    tree = RadixPrefixCache(al, page_size=2)
    pages = al.alloc(3)
    tree.insert([1, 2, 3, 4, 5, 6], pages)
    # align=2 pages: a 3-page walk trims to 2; a 1-page walk trims to 0
    # and counts as a miss with no refs taken
    m = tree.match([1, 2, 3, 4, 5, 6], align=2)
    assert m == pages[:2] and tree.hits == 1 and tree.hit_tokens == 4
    al.unref(m)
    assert tree.match([1, 2, 9], align=2) == []
    assert tree.misses == 1
    assert al.refcount(pages[0]) == 2    # only the insert's and cache's refs


# ------------------------------------------------------------ token identity
@pytest.mark.parametrize("pool", POOLS)
def test_prefix_hit_matches_cold_dense_and_jax(weights, jax_hot, pool):
    """Full hits, suffix hits and sub-prefix hits give the cold paged
    engine's tokens, the dense layout's (fp32 pool: the dense cache
    never round-trips K/V through the int8 store) and the JAX engine's,
    with the same hit counters."""
    prompts = _shared_prompts()
    spec = AttnSpec(kv_dtype=pool)
    _, cold = _serve(weights[1], prompts, prefix=False, attn=spec)
    e2, hot = _serve(weights[1], prompts, prefix=True, attn=spec)
    assert hot == cold, f"hit tokens diverged: {hot} != {cold}"
    jtok, js = jax_hot[pool]
    assert hot == jtok
    if pool == "fp32":
        _, dense = _serve(weights[1], prompts, prefix=None,
                          attn=AttnSpec(layout="dense"))
        assert dense == cold
    s = e2.summary()
    assert s["prefix_hits"] > 0 and s["prefix_hit_tokens"] > 0
    assert s["cow_copies"] >= 1          # the two full hits COW their tail
    assert s["pages_cached"] > 0
    for key in ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "cow_copies", "pages_cached", "prefill_calls",
                "prefill_tokens"):
        assert s[key] == js[key], key
    e2.prefix.clear()
    e2.pages.allocator.assert_drained()


def test_long_prompt_hit_matches_cold(weights):
    """A prompt past the largest bucket sharing a long prefix goes through
    the deferred (late-matched) chunked path and gives the cold chunked
    path's tokens."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 250, size=40).tolist()   # > bucket 32
    prompts = [shared + rng.integers(1, 250, size=4 + i).tolist()
               for i in range(2)]
    _, cold = _serve(weights[1], prompts, prefix=False)
    e2, hot = _serve(weights[1], prompts, prefix=True)
    assert hot == cold
    # the second long prompt, admitted in the same wave, hit the pages
    # the first one registered moments earlier (deferred matching)
    assert e2.summary()["prefix_hits"] >= 1


# ------------------------------------------------------- refcount invariants
def _check_refcounts(eng):
    """Every page's refcount == its slot owners + prefix-cache residency."""
    owners = Counter()
    for pages in eng.pages._slot_pages.values():
        owners.update(pages)
    cached = set()
    stack = list(eng.prefix._root.children.values())
    while stack:
        n = stack.pop()
        cached.add(n.page)
        stack.extend(n.children.values())
    al = eng.pages.allocator
    for p in range(1, eng.pages.num_pages):
        assert al.refcount(p) == owners[p] + (p in cached), \
            f"page {p}: refs {al.refcount(p)} != owners {owners[p]} " \
            f"+ cached {p in cached}"
    assert al.available + al.in_use == al.capacity


@pytest.mark.parametrize("pool", POOLS)
def test_refcounts_under_interleaved_submit_finish(weights, pool):
    prompts = _shared_prompts(n_tail=4, seed=3)
    eng = _engine(weights[1], prefix_cache=True, attn=AttnSpec(kv_dtype=pool))
    for uid, p in enumerate(prompts):
        # staggered budgets: slots finish and refill mid-flight
        eng.submit(Request(uid, p, max_new_tokens=3 + (uid % 3)))
    steps = 0
    while (eng._queue or eng._active) and steps < 200:
        eng.step()
        _check_refcounts(eng)
        steps += 1
    assert not eng._queue and not eng._active
    # drained: only the prefix cache holds pages
    assert eng.pages.pages_in_use == eng.prefix.cached_pages
    assert eng.prefix.clear() > 0
    eng.pages.allocator.assert_drained()


# ------------------------------------------------------------------ COW
@pytest.mark.parametrize("pool", POOLS)
def test_cow_on_shared_tail_extension(weights, pool):
    """A full-prefix hit extends the shared chain's tail: the last shared
    page is COW'd, so the donor's cached page bytes never change."""
    rng = np.random.default_rng(11)
    donor = rng.integers(1, 250, size=13).tolist()
    spec = AttnSpec(kv_dtype=pool)
    eng = _engine(weights[1], max_batch=1, prefix_cache=True, attn=spec)
    eng.submit(Request(0, donor, max_new_tokens=3))
    eng.run()
    # the donor cached (13-1)//2 = 6 pages covering tokens [0, 12)
    assert eng.prefix.cached_pages == 6
    matched = eng.prefix.match(donor[:12])
    tail_page = matched[-1]
    eng.pages.allocator.unref(matched)   # the match refs were the caller's
    before = {k: v[:, tail_page].clone() for k, v in eng.pages.cache.items()}

    eng.submit(Request(1, donor[:12], max_new_tokens=3))   # full hit
    res = eng.run()
    assert eng.summary()["cow_copies"] == 1
    for k, v in eng.pages.cache.items():
        assert torch.equal(v[:, tail_page], before[k]), k

    solo = _engine(weights[1], max_batch=1, prefix_cache=False, attn=spec)
    solo.submit(Request(9, donor[:12], max_new_tokens=3))
    assert res[1].tokens == solo.run()[9].tokens


def test_write_floor_fences_shared_pages(weights):
    """Even with COW bypassed, the write floor the decode reads redirects
    writes below it to the scratch page."""
    eng = _engine(weights[1], max_len=32, prefix_cache=False)
    eng.submit(Request(0, [5, 6, 7, 8], max_new_tokens=2))
    eng._admit()
    slot_pages = eng.pages.slot_pages(0)
    # raise the floor above every page: all decode writes must divert
    eng._floor[0] = len(slot_pages)
    before = {p: eng.pages.cache["k_pages"][:, p].clone()
              for p in slot_pages}
    eng.step()
    for p, b in before.items():
        assert torch.equal(b, eng.pages.cache["k_pages"][:, p]), \
            f"page {p} written below the floor"


# ------------------------------------------------------------------ eviction
def test_eviction_under_pressure(weights):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, size=20).tolist() for _ in range(3)]
    # the pool fits the 2nd and 3rd distinct prompts only by evicting the
    # previous prompt's cached pages
    eng = _engine(weights[1], max_batch=1, max_len=32, num_pages=1 + 14,
                  prefix_cache=True)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=4))
    res = eng.run()
    assert eng.summary()["prefix_evictions"] > 0, \
        "pool pressure produced no eviction"
    assert all(len(r.tokens) == 4 for r in res.values())
    solo = _engine(weights[1], max_batch=1, max_len=32, prefix_cache=False)
    solo.submit(Request(9, prompts[-1], max_new_tokens=4))
    assert res[2].tokens == solo.run()[9].tokens


def test_hit_unwinds_cleanly_on_pool_exhaustion(weights):
    """A hit whose fresh pages cannot be reserved releases its match refs
    and goes back on the queue: refcounts stay balanced and the engine
    keeps serving after the failure surfaces."""
    rng = np.random.default_rng(13)
    donor = rng.integers(1, 250, size=16).tolist()
    eng = _engine(weights[1], max_len=32, num_pages=1 + 22,
                  prefix_cache=True)
    eng.submit(Request(0, donor, max_new_tokens=2))
    eng.run()                              # caches (16-1)//2 = 7 pages
    eng.submit(Request(1, rng.integers(1, 250, size=20).tolist(),
                       max_new_tokens=4))
    eng._admit()                           # a live blocker slot: 12 pages
    # a suffix hit needing 8 fresh pages with 3 free and the donor's
    # cached pages pinned by the match itself: the reservation fails,
    # and so does the cold fallback
    eng.submit(Request(2, donor + rng.integers(1, 250, size=10).tolist(),
                       max_new_tokens=4))
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.step()
    assert len(eng._queue) == 1            # requeued, not dropped
    _check_refcounts(eng)                  # match refs released
    eng._queue.clear()                     # drop the unserviceable request
    res = eng.run()
    assert len(res[1].tokens) == 4         # the blocker still completes


def test_hit_falls_back_to_cold_when_own_match_pins_pool(weights):
    """A full hit whose own match refs pin every evictable page releases
    them and serves cold, which may evict the very pages it wanted."""
    rng = np.random.default_rng(17)
    donor = rng.integers(1, 250, size=16).tolist()
    eng = _engine(weights[1], max_len=32, num_pages=1 + 20,
                  prefix_cache=True)
    eng.submit(Request(0, donor, max_new_tokens=2))
    eng.run()                              # caches 7 pages
    eng.submit(Request(1, rng.integers(1, 250, size=20).tolist(),
                       max_new_tokens=4))
    eng._admit()                           # a hog slot: 12 pages, 1 free
    # the full hit needs 2 fresh (COW + generation) with 1 free and every
    # cached page pinned by this match: it must fall back to cold
    eng.submit(Request(2, donor[:14], max_new_tokens=2))
    res = eng.run()
    assert len(res[2].tokens) == 2 and len(res[1].tokens) == 4
    assert eng.summary()["prefix_evictions"] > 0   # the cold path evicted
    solo = _engine(weights[1], max_batch=1, max_len=32, prefix_cache=False)
    solo.submit(Request(9, donor[:14], max_new_tokens=2))
    assert res[2].tokens == solo.run()[9].tokens


def test_pool_exhaustion_still_raises_when_nothing_evictable(weights):
    eng = _engine(weights[1], max_len=32, num_pages=1 + 12,
                  prefix_cache=True)
    eng.submit(Request(0, list(range(1, 21)), max_new_tokens=4))
    eng._admit()                          # slot 0 holds 12 pages, 0 free
    eng.submit(Request(1, list(range(30, 50)), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="exhausted"):
        eng._admit()                      # nothing evictable: all slot-owned


# ------------------------------------------------------------- poison / free
@pytest.mark.parametrize("pool", POOLS)
def test_nan_poison_on_last_unref_only(pool):
    """poison_view() is the format-independent face of the poison: NaN K
    in the fp32 pool, a NaN page scale in the quantized one; a page
    re-entering a row has its scale revived."""
    pages_c = PagedKVCache(_qwen(), batch=2, max_len=8, device="cpu",
                           kv_dtype=pool, poison_freed=True)
    pages = pages_c.alloc(0, 6)           # 3 pages, refcount 1 each
    idx = torch.tensor(pages)
    kp = pages_c.cache["k_pages"]
    kp[:, idx] = torch.ones_like(kp[:, idx])
    pages_c.allocator.ref([pages[0]])     # pages[0] shared by a 2nd owner
    pages_c.free(0)
    poisoned = pages_c.poison_view()
    assert not poisoned[:, pages[0]].any(), \
        "shared page poisoned before its last unref"
    assert poisoned[:, pages[1]].all() and poisoned[:, pages[2]].all()
    pages_c.allocator.unref([pages[0]])   # last owner gone -> poison
    assert pages_c.poison_view()[:, pages[0]].all()
    if pool != "fp32":
        pages_c.alloc(1, 6)               # reused: the scale is revived
        assert not pages_c.poison_view()[:, pages].any()


# ------------------------------------------- pool bytes against the reference
def _leaf(x):
    """A pool leaf as numpy; fp8 pages by their values (NaN == NaN)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == F8 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.float8_e4m3fn
                      else x)


@pytest.mark.parametrize("kv_dtype,kv_scale", [
    ("int8", "grid"), ("fp8_v", "grid"), ("int8", "absmax"), ("fp32", "grid")])
def test_pool_bytes_match_jax_after_cow_and_gather(kv_dtype, kv_scale):
    """The same request cache inserted into both pools (the second slot's
    first page shared, as a suffix hit's), then a COW of a shared page
    into a fresh one and a gather of the shared pages: every pool leaf
    and the gathered request cache equal the reference's exactly."""
    cfg = _qwen()
    rng = np.random.default_rng(4)
    L, N, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = (L, 1, 16, N, hd)
    # values on the pool grid (multiples of 2^-3 in range), so the int8
    # codes, fp8 V and the model-dtype pages all hold them exactly
    rc = {"k": rng.integers(-100, 101, shape).astype(np.float32) / 8,
          "v": rng.integers(-100, 101, shape).astype(np.float32) / 8}
    jp = JPagedKVCache(_jqwen(), 2, 32, kv_dtype=kv_dtype, kv_scale=kv_scale)
    tp = PagedKVCache(cfg, 2, 32, device="cpu", kv_dtype=kv_dtype,
                      kv_scale=kv_scale)
    for p in (jp, tp):
        p.alloc(0, 16)
    jp.insert({k: jnp.asarray(v) for k, v in rc.items()}, 0)
    tp.insert({k: torch.from_numpy(v) for k, v in rc.items()}, 0)
    shared = tp.slot_pages(0)[:4]
    assert shared == jp.slot_pages(0)[:4]
    for p in (jp, tp):
        p.allocator.ref(shared)
        fresh = p.allocator.alloc(3)
        p.assign(1, shared + fresh, first_owned=len(shared))
        # the second slot's own request cache: only pages past the
        # shared span are written (first_page), the rest to scratch
        p.cow(shared[-1], fresh[0])
        assert p.first_owned(1) == len(shared)
    rc2 = {k: (rng.integers(-100, 101, shape) / 8).astype(np.float32)
           for k in rc}
    jp.insert({k: jnp.asarray(v) for k, v in rc2.items()}, 1,
              first_page=len(shared))
    tp.insert({k: torch.from_numpy(v) for k, v in rc2.items()}, 1,
              first_page=len(shared))
    assert set(tp.cache) == set(jp.cache)
    for name in tp.cache:
        # page 0 is the scratch page: redirected writes land there in an
        # unspecified order
        np.testing.assert_array_equal(_leaf(tp.cache[name])[:, 1:],
                                      _leaf(jp.cache[name])[:, 1:],
                                      err_msg=name)
    got = tp.gather_prefix(shared)
    want = jp.gather_prefix(shared)
    m = len(shared) * tp.page_size
    for name in ("k", "v"):
        assert got[name].shape == tuple(want[name].shape)
        np.testing.assert_array_equal(got[name][:, :, :m].numpy(),
                                      np.asarray(want[name])[:, :, :m],
                                      err_msg=name)


# ------------------------------------------------------- per-slot stat mask
def test_parked_slots_masked_from_stats(weights):
    eng = _engine(weights[1], max_len=32, collect_stats=True)
    stats = {"block_sparsity": np.asarray([[0.5, 1.0], [0.5, 1.0]]),
             "head_sparsity": np.asarray([[0.25, 1.0], [0.25, 1.0]])}
    eng._record_stats(stats, mask=np.array([True, False]))
    assert eng.metrics["block_sparsity"] == pytest.approx(0.5)
    assert eng.metrics["head_sparsity"] == pytest.approx(0.25)


def test_engine_decode_stats_are_per_slot(weights):
    """With one slot parked the recorded sparsity uses only the live
    slot (equal to serving the request alone)."""
    cfg = reduced(get_config("qwen2-1.5b"))
    cfg = cfg.replace(hdp=cfg.hdp.replace(calib="none"))
    prompt = np.random.default_rng(2).integers(1, 250, size=10).tolist()
    sums = []
    for batch in (1, 2):
        eng = _engine(weights[1], cfg=cfg, max_batch=batch,
                      collect_stats=True)
        eng.submit(Request(0, prompt, max_new_tokens=4))
        eng.run()
        sums.append(eng.summary())
    for key in ("block_sparsity", "page_sparsity"):
        assert sums[1][key] == pytest.approx(sums[0][key], abs=1e-6)


# ---------------------------------------------------------------- guardrails
def test_prefix_cache_requires_paged_layout(weights):
    with pytest.raises(ValueError, match="paged"):
        _engine(weights[1], max_batch=1, max_len=32, prefix_cache=True,
                attn=AttnSpec(layout="dense"))


def test_prefix_cache_env_default(monkeypatch, weights):
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    kw = dict(max_batch=1, max_len=32)
    assert _engine(weights[1], **kw).prefix is not None
    # an explicit argument wins over the env; the dense layout degrades
    assert _engine(weights[1], prefix_cache=False, **kw).prefix is None
    assert _engine(weights[1], attn=AttnSpec(layout="dense"),
                   **kw).prefix is None
    # and a layout whose chunks miss HDP's q blocks cannot share pages
    odd = _qwen().replace(hdp=_qwen().hdp.replace(block_q=3))
    assert _engine(weights[1], cfg=odd, **kw).prefix is None
    with pytest.raises(ValueError, match="block_q"):
        _engine(weights[1], cfg=odd, prefix_cache=True, **kw)
