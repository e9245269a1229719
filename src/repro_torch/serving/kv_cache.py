"""KV-cache layouts of the serving engine: dense slots and block pages.

PyTorch counterpart of ``repro.serving.kv_cache``:

* ``SlotCache`` — the dense per-slot layout: one contiguous
  [L, batch, max_len, N, hd] K and V in the model's dtype; ``insert``
  copies a row of a freshly prefilled request cache into a slot (zero
  past its length), ``clear`` zeroes a slot when its request finishes;
* ``PagedKVCache`` — one shared page pool plus per-slot page tables.
  With HDP on the page size is HDP's ``block_k``, so cache pages
  coincide with the scout's pruning blocks (16 positions with HDP off).

Every update is made in place on the cache tensors, where the reference
donates its buffers to a jitted call and receives the aliased result.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.quant import (absmax_page_scale, encode_pool,
                                    encode_pool_scaled, pool_int_bits,
                                    pool_scale, scout_int_codes, to_fp8_e4m3)
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.serving.allocator import PageAllocator

#: storage formats of the paged pool: int8 codes + per-page scale (the
#: default), int8 K + fp8 V, or the unquantized pool in the model dtype
KV_DTYPES = ("fp32", "int8", "fp8_v")

#: scale calibration of a quantized pool: the static power-of-two grid
#: or per-page calibrated absmax scales
KV_SCALES = ("grid", "absmax")


def cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


class SlotCache:
    """Dense per-slot layout: ``cache`` holds ``k``/``v``
    [L, batch, max_len, N, hd] in the model's dtype, one fixed buffer for
    the cache's lifetime (a captured decode graph reads it at a fixed
    address)."""

    def __init__(self, cfg, batch: int, max_len: int, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.cache = registry.init_cache(cfg, batch, max_len, device=device)

    def insert(self, one_cache: Dict[str, torch.Tensor], slot: int,
               row: int = 0) -> None:
        """Copy row ``row`` of a request cache ({"k","v"} [L,B,S,N,hd],
        S <= max_len) into ``slot``, zeroing the slot past S."""
        for name, big in self.cache.items():
            small = one_cache[name][:, row]
            S = small.shape[1]
            if S > self.max_len:
                raise ValueError(f"request cache of {S} positions exceeds "
                                 f"the serving cache ({self.max_len})")
            big[:, slot, :S].copy_(small)
            big[:, slot, S:].zero_()

    def clear(self, slot: int) -> None:
        for big in self.cache.values():
            big[:, slot].zero_()

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

    Page 0 is the reserved *scratch* page: bucket padding and parked
    slots' decode writes land there, so it holds arbitrary but finite
    values and is always masked. Pages are allocated per request for
    ``prompt + max_new`` tokens; ownership lives in ``self.allocator``.
    """

    def __init__(self, cfg, batch: int, max_len: int, device="cuda",
                 kv_dtype: str = "int8", kv_scale: str = "grid"):
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
        # one full table per slot plus the scratch page
        self.num_pages = 1 + batch * self.pages_per_slot
        self.int_bits = pool_int_bits(hdp)
        nL, N, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
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
        self.allocator = PageAllocator(self.num_pages, reserved=1)
        self._slot_pages: Dict[int, List[int]] = {}
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

    def assign(self, slot: int, pages: List[int]) -> None:
        """Install ``pages`` (each holding one ref owned by this slot) as
        the slot's table row."""
        if slot in self._slot_pages:
            self.free(slot)
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {len(pages)} pages exceed table width "
                f"{self.pages_per_slot}")
        self._slot_pages[slot] = list(pages)
        self._table[slot, :] = 0
        self._table[slot, :len(pages)] = pages
        self._upload_row(slot)
        self.peak_pages = max(self.peak_pages, self.pages_in_use)

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
        """Release the slot's page refs and zero its table row."""
        self.allocator.unref(self._slot_pages.pop(slot, []))
        self._table[slot, :] = 0
        self._upload_row(slot)

    # -------------------------------------------------------------- insert
    def insert(self, one_cache: Dict[str, torch.Tensor], slot: int,
               row: int = 0) -> None:
        """Scatter row ``row`` of a dense request cache ({"k","v"}
        [L,B,S,N,hd]) into ``slot``'s pages, in place, encoded in the
        pool's format (scales are rewritten with the codes).

        Cache pages past the slot's allocation (bucket padding) redirect
        to the scratch page. On the grid the codes are the exact encode
        of the request cache's values, which prefill has already snapped
        to the pool grid."""
        pages = self._slot_pages[slot]
        ps = self.page_size
        k = one_cache["k"][:, row]
        v = one_cache["v"][:, row]
        nL, S, N, hd = k.shape
        npg = min(-(-S // ps), self.pages_per_slot)
        idx = np.zeros(npg, np.int64)
        hi = min(len(pages), npg)
        idx[:hi] = pages[:hi]
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
            if self.scout:
                hdp = self.cfg.hdp
                c["k_scout"][:, dst] = scout_int_codes(kp, hdp.int_bits,
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

    # ------------------------------------------------------------ metrics
    def _page_bytes(self) -> int:
        return sum(t.element_size() * int(np.prod(t.shape[2:]))
                   for t in self.cache.values()) * self.cfg.n_layers

    def active_bytes(self, pages: Optional[int] = None) -> int:
        """Bytes resident for ``pages`` allocated pages (default: now)."""
        n = self.pages_in_use if pages is None else pages
        return n * self._page_bytes()

    def bytes_per_token(self) -> float:
        """Resident pool bytes per cached token, over every pool leaf
        (codes or values, per-page scales, the scout copy)."""
        return self._page_bytes() / self.page_size

    def pool_bytes(self) -> int:
        return cache_bytes(self.cache)
