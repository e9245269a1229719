"""KV-cache layouts of the serving engine: dense slots and block pages.

PyTorch counterpart of ``repro.serving.kv_cache``:

* ``SlotCache`` — the dense per-slot layout over any family's cache
  tree (the transformer's [L, batch, max_len, N, hd] K and V, a
  recurrent family's state, zamba2's tree of both), each leaf's batch
  axis named by ``registry.cache_specs``; ``insert`` copies a row of a
  freshly prefilled request cache into a slot (zero past a shorter
  request cache's extent), ``clear`` zeroes a slot when its request
  finishes;
* ``PagedKVCache`` — one shared page pool plus per-slot page tables.
  With HDP on the page size is HDP's ``block_k``, so cache pages
  coincide with the scout's pruning blocks (16 positions with HDP off).
  Pages are refcounted (``allocator.PageAllocator``), so a slot's table
  row may start with read-only prefix pages it shares with other slots
  and the radix prefix cache (``first_owned`` marks where its own pages
  begin); ``cow`` copies a shared page into an owned one, and
  ``gather_prefix`` seeds a request cache from shared pages.

Every update is made in place on the cache tensors, where the reference
donates its buffers to a jitted call and receives the aliased result.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import (POISON_CODE, absmax_page_scale,
                                    encode_pool, encode_pool_scaled,
                                    pool_int_bits, pool_scale,
                                    scout_frac_codes, scout_int_codes,
                                    to_fp8_e4m3)
from repro_torch.distribution.tp import gather_heads, local_heads, mesh_tp
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.serving.allocator import PageAllocator

#: storage formats of the paged pool: int8 codes + per-page scale (the
#: default), int8 K + fp8 V, or the unquantized pool in the model dtype
KV_DTYPES = ("fp32", "int8", "fp8_v")

#: scale calibration of a quantized pool: the static power-of-two grid
#: or per-page calibrated absmax scales
KV_SCALES = ("grid", "absmax")


def cache_bytes(cache) -> int:
    """Bytes of every leaf of a cache tree."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    return cache.numel() * cache.element_size()


def cache_leaves(cache, specs):
    """(leaf, its logical axis names) over a cache tree and its
    ``registry.cache_specs`` tree."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from cache_leaves(v, specs[k])
    else:
        yield cache, tuple(specs)


class SlotCache:
    """Dense per-slot layout: ``cache`` is the family's request cache
    tree at ``batch`` slots and ``max_len`` positions, each leaf one
    fixed buffer for the cache's lifetime (a captured decode graph reads
    it at a fixed address), its batch axis where ``registry.cache_specs``
    names it (the reference's ``_batch_axes``)."""

    def __init__(self, cfg, batch: int, max_len: int, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.cache = registry.init_cache(cfg, batch, max_len, device=device)
        self.specs = registry.cache_specs(cfg)

    def leaves(self, cache=None):
        """(leaf, its batch axis, its position axis or None) over
        ``cache`` (default the serving cache)."""
        for t, ax in cache_leaves(self.cache if cache is None else cache,
                                  self.specs):
            yield (t, ax.index("batch"),
                   ax.index("kv_seq") if "kv_seq" in ax else None)

    def insert(self, one_cache, slot: int, row: int = 0) -> None:
        """Copy row ``row`` of a request cache (the same tree, batch on
        the same axes, every other dim at most the serving cache's) into
        ``slot``, zero-padding each dim the request cache is shorter in
        (the positions past a bucketed prefill)."""
        for (big, ax, _), (small, _, _) in zip(self.leaves(),
                                               self.leaves(one_cache)):
            src, dst = small.select(ax, row), big.select(ax, slot)
            if any(s > d for s, d in zip(src.shape, dst.shape)):
                raise ValueError(f"request cache {tuple(small.shape)} "
                                 f"exceeds the serving cache "
                                 f"{tuple(big.shape)}")
            if src.shape != dst.shape:
                dst.zero_()
                dst = dst[tuple(slice(0, n) for n in src.shape)]
            dst.copy_(src)

    def clear(self, slot: int) -> None:
        for big, ax, _ in self.leaves():
            big.select(ax, slot).zero_()

    def bytes_per_token(self) -> float:
        """Resident bytes per cache position of one slot."""
        return cache_bytes(self.cache) / (self.batch * self.max_len)


class PagedKVCache:
    """Page pool + per-slot page tables.

    ``kv_dtype`` selects the pool format ([L, P, ps, N, hd] pages):

    * ``"int8"`` — K and V as int8 codes with per-page per-kv-head
      scales ``k_scale``/``v_scale`` [L, P, N]; the decode scout reads a
      finite view of the K codes;
    * ``"fp8_v"`` — int8 K as above, V as float8_e4m3fn with its scale
      fixed at 1.0 (the fp8 exponent does the scale's job);
    * ``"fp32"`` — the unquantized pool in the model's dtype (bf16 at
      full width, despite the reference's name), plus, with HDP on, the
      int8 scout copy of K (``k_scout``) written with the pages.

    ``kv_scale`` calibrates a quantized pool: ``"grid"``, the static
    power-of-two step of ``pool_scale``, or ``"absmax"``, per-page scales
    max|x| / 127 set when a page is inserted. With HDP off no scout runs:
    the pool grid is Q4 and pages hold 16 positions.

    Page 0 is the reserved *scratch* page: bucket padding, parked
    slots' decode writes and writes below a slot's write floor land
    there, so it holds arbitrary but finite values and is always masked.
    Pages are allocated per request for ``prompt + max_new`` tokens;
    ownership lives in ``self.allocator``. ``num_pages`` overrides the
    pool size (default: one full table per slot plus the scratch page).

    ``draft_scout`` asks an unquantized pool with HDP on for the int8
    quantized-fraction copy of K (``f_scout``), which the speculative
    draft scores from; a quantized pool derives it from its codes, so
    the flag allocates nothing there.

    ``poison_freed`` (debug) poisons a page's K when its last owner lets
    go, never while it is shared: NaN in an unquantized pool's
    ``k_pages``, a NaN ``k_scale`` in a quantized one (NaN has no int8
    code). A stale read of a freed page then turns the logits NaN.
    ``assign`` revives a quantized page's scale when it re-enters a
    table row.

    ``mesh`` (a serving mesh whose ``model`` axis is tp > 1) shards the
    pool over KV heads: every leaf holds this rank's N/tp heads
    (``distribution.tp.pool_shardings``), ``insert`` writes only those
    heads of a replicated request cache, and ``gather_prefix`` gathers
    the other ranks' heads back. ``pool_bytes``, ``active_bytes`` and
    ``bytes_per_token`` keep the global meaning (every shard's bytes);
    ``pool_bytes_per_shard`` is this rank's.
    """

    def __init__(self, cfg, batch: int, max_len: int, device="cuda",
                 kv_dtype: str = "int8", kv_scale: str = "grid",
                 num_pages: Optional[int] = None,
                 poison_freed: bool = False, draft_scout: bool = False,
                 mesh=None):
        hdp = cfg.hdp
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if kv_scale not in KV_SCALES:
            raise ValueError(
                f"kv_scale must be one of {KV_SCALES}, got {kv_scale!r}")
        if kv_scale == "absmax" and kv_dtype == "fp32":
            raise ValueError(
                "kv_scale='absmax' calibrates a quantized pool's scales; "
                "fp32 pools have none (use kv_dtype='int8'/'fp8_v')")
        self.kv_dtype = kv_dtype
        self.kv_scale = kv_scale
        self.quantized = kv_dtype != "fp32"
        self.scout = hdp is not None and hdp.enabled
        self.draft_scout = draft_scout and self.scout
        ps = hdp.block_k if self.scout else 16
        if self.scout and hdp.int_bits > 6:
            raise ValueError(
                f"int_bits={hdp.int_bits} exceeds the int8 scout copy's "
                "range (integer parts reach +/-2^int_bits; need <= 6)")
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.page_size = ps
        self.device = torch.device(device)
        self.pages_per_slot = -(-max_len // ps)
        # by default one full table per slot plus the scratch page
        self.num_pages = (1 + batch * self.pages_per_slot
                          if num_pages is None else num_pages)
        self.poison_freed = poison_freed
        self.int_bits = pool_int_bits(hdp)
        nL, N, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        self.mesh = mesh
        self.tp = mesh_tp(mesh)
        if N % self.tp:
            raise ValueError(f"n_kv_heads={N} not divisible by tp={self.tp}")
        # the resident pool lives head-sharded: this rank holds N/tp heads
        # of every page's codes, scales and scout views
        N //= self.tp
        shape = (nL, self.num_pages, ps, N, hd)
        if self.quantized:
            v_dt = torch.float8_e4m3fn if kv_dtype == "fp8_v" else torch.int8
            s0 = pool_scale(self.int_bits)
            self.cache: Dict[str, torch.Tensor] = {
                "k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_pages": torch.zeros(shape, dtype=v_dt, device=device),
                "k_scale": torch.full((nL, self.num_pages, N), s0,
                                      dtype=torch.float32, device=device),
                "v_scale": torch.full((nL, self.num_pages, N),
                                      1.0 if kv_dtype == "fp8_v" else s0,
                                      dtype=torch.float32, device=device),
            }
        else:
            dt = L.torch_dtype(cfg.dtype)
            self.cache = {
                "k_pages": torch.zeros(shape, dtype=dt, device=device),
                "v_pages": torch.zeros(shape, dtype=dt, device=device),
            }
            if self.scout:
                self.cache["k_scout"] = torch.zeros(shape, dtype=torch.int8,
                                                    device=device)
            if self.draft_scout:
                self.cache["f_scout"] = torch.zeros(shape, dtype=torch.int8,
                                                    device=device)
        self.allocator = PageAllocator(self.num_pages, reserved=1,
                                       on_free=self._on_free)
        self._slot_pages: Dict[int, List[int]] = {}
        self._slot_floor: Dict[int, int] = {}
        self._table = np.zeros((batch, self.pages_per_slot), np.int32)
        # one static device table, rewritten in place row by row: a
        # captured decode graph reads it at a fixed address
        self._table_dev = torch.zeros((batch, self.pages_per_slot),
                                      dtype=torch.int32, device=device)
        self.peak_pages = 0

    # ---------------------------------------------------------- host state
    @property
    def pages_in_use(self) -> int:
        return self.allocator.in_use

    def table(self) -> torch.Tensor:
        """The device page table [batch, pages_per_slot] int32: one
        buffer for the cache's lifetime, whose rows alloc/free rewrite in
        place."""
        return self._table_dev

    def _upload_row(self, slot: int) -> None:
        self._table_dev[slot].copy_(torch.from_numpy(self._table[slot]))

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, []))

    def first_owned(self, slot: int) -> int:
        """Index of the slot's first owned (writable) page in its table
        row; the entries before it are shared read-only prefix pages."""
        return self._slot_floor.get(slot, 0)

    def assign(self, slot: int, pages: List[int],
               first_owned: int = 0) -> None:
        """Install ``pages`` (each holding one ref owned by this slot) as
        the slot's table row; entries before ``first_owned`` are shared
        prefix pages that the decode's write floor fences."""
        if slot in self._slot_pages:
            self.free(slot)
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {len(pages)} pages exceed table width "
                f"{self.pages_per_slot}")
        self._slot_pages[slot] = list(pages)
        self._slot_floor[slot] = first_owned
        self._table[slot, :] = 0
        self._table[slot, :len(pages)] = pages
        self._upload_row(slot)
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        if self.poison_freed and self.quantized and pages:
            # a freed quantized page's poison is its NaN scale: revive it
            # as the page re-enters a row (insert and COW rewrite it too,
            # but a page first touched by a decode write gets codes only)
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            self.cache["k_scale"][:, idx] = pool_scale(self.int_bits)

    def alloc(self, slot: int, n_tokens: int) -> List[int]:
        """Reserve fresh pages for ``n_tokens`` cache positions of a slot."""
        if slot in self._slot_pages:
            self.free(slot)
        need = max(1, -(-n_tokens // self.page_size))
        if need > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed max_len {self.max_len}")
        pages = self.allocator.alloc(need)
        self.assign(slot, pages)
        return pages

    def free(self, slot: int) -> None:
        """Release the slot's page refs (a page returns to the free list
        only when unshared) and zero its table row."""
        self.allocator.unref(self._slot_pages.pop(slot, []))
        self._slot_floor.pop(slot, None)
        self._table[slot, :] = 0
        self._upload_row(slot)

    def _on_free(self, pages: List[int]) -> None:
        if self.poison_freed and pages:
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            if self.quantized:
                self.cache["k_scale"][:, idx] = float("nan")
            else:
                self.cache["k_pages"][:, idx] = float("nan")

    def poison_view(self) -> np.ndarray:
        """Poison marks of K, shaped like ``k_pages``: NaN in an
        unquantized pool, the -128 code or a NaN page scale in a
        quantized one."""
        kp = self.cache["k_pages"]
        if not self.quantized:
            return torch.isnan(kp).cpu().numpy()
        scl = torch.isnan(self.cache["k_scale"])               # [L, P, N]
        return ((kp == POISON_CODE) | scl[:, :, None, :, None]).cpu().numpy()

    # -------------------------------------------------------------- insert
    def insert(self, one_cache: Dict[str, torch.Tensor], slot: int,
               row: int = 0, first_page: int = 0) -> None:
        """Scatter row ``row`` of a dense request cache ({"k","v"}
        [L,B,S,N,hd]) into ``slot``'s pages, in place, encoded in the
        pool's format (scales are rewritten with the codes).

        Cache pages past the slot's allocation (bucket padding) and
        before ``first_page`` (a shared prefix, already resident) redirect
        to the scratch page. On the grid the codes are the exact encode
        of the request cache's values, which prefill has already snapped
        to the pool grid."""
        pages = self._slot_pages[slot]
        ps = self.page_size
        k = local_heads(one_cache["k"][:, row], 2, self.mesh)
        v = local_heads(one_cache["v"][:, row], 2, self.mesh)
        nL, S, N, hd = k.shape
        npg = min(-(-S // ps), self.pages_per_slot)
        idx = np.zeros(npg, np.int64)
        hi = min(len(pages), npg)
        idx[first_page:hi] = pages[first_page:hi]
        pad = npg * ps - S
        if pad > 0:
            k = torch.cat([k, k.new_zeros((nL, pad, N, hd))], dim=1)
            v = torch.cat([v, v.new_zeros((nL, pad, N, hd))], dim=1)
        kp = k[:, :npg * ps].reshape(nL, npg, ps, N, hd)
        vp = v[:, :npg * ps].reshape(nL, npg, ps, N, hd)
        dst = torch.from_numpy(idx).to(self.device)
        c = self.cache
        if not self.quantized:
            c["k_pages"][:, dst] = kp.to(c["k_pages"].dtype)
            c["v_pages"][:, dst] = vp.to(c["v_pages"].dtype)
            hdp = self.cfg.hdp
            if self.scout:
                c["k_scout"][:, dst] = scout_int_codes(kp, hdp.int_bits,
                                                       hdp.frac_bits)
            if self.draft_scout:
                c["f_scout"][:, dst] = scout_frac_codes(kp, hdp.int_bits,
                                                        hdp.frac_bits)
            return
        if self.kv_scale == "absmax":
            ks = absmax_page_scale(kp, self.int_bits)           # [L,npg,N]
            kq = encode_pool_scaled(kp, ks[:, :, None, :, None])
        else:
            ks = torch.full((nL, npg, N), pool_scale(self.int_bits),
                            dtype=torch.float32, device=self.device)
            kq = encode_pool(kp, self.int_bits)
        if self.kv_dtype == "fp8_v":
            vq = to_fp8_e4m3(vp)
            vs = torch.ones_like(ks)
        elif self.kv_scale == "absmax":
            vs = absmax_page_scale(vp, self.int_bits)
            vq = encode_pool_scaled(vp, vs[:, :, None, :, None])
        else:
            vs = torch.full_like(ks, pool_scale(self.int_bits))
            vq = encode_pool(vp, self.int_bits)
        c["k_pages"][:, dst] = kq
        c["v_pages"][:, dst] = vq
        c["k_scale"][:, dst] = ks
        c["v_scale"][:, dst] = vs

    # ----------------------------------------------------- prefix sharing
    def cow(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` into the owned page
        ``dst`` in every pool leaf (codes, scales, scout copies)."""
        for leaf in self.cache.values():
            leaf[:, dst] = leaf[:, src]

    def gather_prefix(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """A request cache {"k","v"} [L,1,max_len,N,hd] in the model's
        dtype seeded with the shared prefix ``pages``, which the suffix's
        chunked prefill then appends to. Positions past the prefix read
        the scratch page (finite, and masked by every attention path). A
        quantized pool dequantizes its codes (codes x page scale), which
        gives exactly the values a cold prefill wrote: grid codes and
        fp8 V are exact in bf16. (The reference returns fp32 here, so on
        a bf16 model its hits round p apart from its cold prefill:
        ``tests/test_torch_prefix_bf16.py``.)"""
        idx = np.zeros(self.pages_per_slot, np.int64)
        idx[:len(pages)] = pages
        idx = torch.from_numpy(idx).to(self.device)
        dt = L.torch_dtype(self.cfg.dtype)
        nL, _, ps, N, hd = self.cache["k_pages"].shape

        def to_cache(name, scale):
            g = self.cache[name][:, idx]                    # [L,nP,ps,N,hd]
            if scale is not None:
                g = g.to(torch.float32) * \
                    self.cache[scale][:, idx][:, :, None, :, None]
            g = g.reshape(nL, self.pages_per_slot * ps, N, hd)
            g = g[:, None, :self.max_len].to(dt)
            # every rank's heads: the request cache is replicated
            return gather_heads(g, 3, self.mesh).contiguous()

        if self.quantized:
            # prefix pages are live (never freed-poisoned) and hold no
            # rolled-back positions (only pages before the decode write
            # frontier are cached), so codes x scale is exact here
            return {"k": to_cache("k_pages", "k_scale"),
                    "v": to_cache("v_pages", "v_scale")}
        return {"k": to_cache("k_pages", None),
                "v": to_cache("v_pages", None)}

    # ------------------------------------------------------------ metrics
    def _page_bytes(self) -> int:
        return sum(t.element_size() * int(np.prod(t.shape[2:]))
                   for t in self.cache.values()) * self.cfg.n_layers \
            * self.tp

    def active_bytes(self, pages: Optional[int] = None) -> int:
        """Bytes resident for ``pages`` allocated pages (default: now)."""
        n = self.pages_in_use if pages is None else pages
        return n * self._page_bytes()

    def bytes_per_token(self) -> float:
        """Resident pool bytes per cached token, over every pool leaf
        (codes or values, per-page scales, the scout copy)."""
        return self._page_bytes() / self.page_size

    def pool_bytes(self) -> int:
        """Bytes of the whole pool, over every shard."""
        return cache_bytes(self.cache) * self.tp

    def pool_bytes_per_shard(self) -> int:
        """Resident pool bytes held by this rank: every pool leaf (codes,
        scales, scout views) is head-sharded, so each of the tp shards
        holds exactly 1/tp of the pool."""
        return cache_bytes(self.cache)


def kv_read_bytes_per_step(cfg, seq_len: int, batch: int,
                           hdp_block_sparsity: float = 0.0) -> Tuple[int, int]:
    """(dense, hdp) bytes read from the KV cache per decode step.

    The FUM accounting: pruned KV blocks are never fetched, so HDP decode
    reads ``(1 - sparsity)`` of K/V (the int8 scout copy of K always
    streams). The itemsize is the config's dtype's."""
    if not hasattr(cfg, "n_kv_heads") or cfg.n_kv_heads == 0:
        return 0, 0
    itemsize = L.torch_dtype(cfg.dtype).itemsize
    layers = cfg.n_layers
    kv = 2 * layers * batch * seq_len * cfg.n_kv_heads * cfg.hd * itemsize
    scout = layers * batch * seq_len * cfg.n_kv_heads * cfg.hd  # int8 K
    hdp = int(scout + (1.0 - hdp_block_sparsity) * kv)
    return int(kv), hdp
