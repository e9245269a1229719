"""The int8 block-paged KV pool of the serving engine.

PyTorch counterpart of ``repro.serving.kv_cache.PagedKVCache`` for
``kv_dtype="int8"``, ``kv_scale="grid"``: one shared page pool plus
per-slot page tables, page size = HDP's ``block_k`` so cache pages
coincide with the scout's pruning blocks.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.quant import encode_pool, pool_int_bits, pool_scale
from repro_torch.serving.allocator import PageAllocator

#: the pool format the port serves (static power-of-two ``grid`` scale);
#: fp32 and fp8_v pools and absmax scales are still to come (ROADMAP.md)
KV_DTYPE = "int8"


class PagedKVCache:
    """Page pool + per-slot page tables, aligned to HDP's ``block_k``.

    ``cache`` holds ``k_pages``/``v_pages`` [L, P, page_size, N, hd] int8
    codes on the static power-of-two grid (``core.quant.pool_scale``) and
    ``k_scale``/``v_scale`` [L, P, N] fp32 per-page scales. The decode
    scout reads a finite view of the codes, and the FUM kernel
    dequantizes only the pages that survive it.

    Page 0 is the reserved *scratch* page: bucket padding and inactive
    slots' decode writes land there, so it holds arbitrary but finite
    codes and is always masked. Pages are allocated per request for
    ``prompt + max_new`` tokens; ownership lives in ``self.allocator``.

    Every update (``insert`` and the decode K/V scatter in the model) is
    made in place on these tensors, where the reference donates its
    buffers to a jitted call and receives the aliased result.
    """

    def __init__(self, cfg, batch: int, max_len: int, device="cuda"):
        hdp = cfg.hdp
        if hdp is None or not hdp.enabled:
            raise NotImplementedError(
                "HDP-off paged serving is not ported yet (ROADMAP.md "
                "section 1)")
        ps = hdp.block_k
        if hdp.int_bits > 6:
            raise ValueError(
                f"int_bits={hdp.int_bits} exceeds the int8 scout view's "
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
        L, N, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        shape = (L, self.num_pages, ps, N, hd)
        s0 = pool_scale(self.int_bits)
        self.cache: Dict[str, torch.Tensor] = {
            "k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.full((L, self.num_pages, N), s0,
                                  dtype=torch.float32, device=device),
            "v_scale": torch.full((L, self.num_pages, N), s0,
                                  dtype=torch.float32, device=device),
        }
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
        [L,B,S,N,hd]) into ``slot``'s pages, in place.

        Cache pages past the slot's allocation (bucket padding) redirect
        to the scratch page. The codes are the exact encode of the request
        cache's values, which prefill has already snapped to the pool
        grid."""
        pages = self._slot_pages[slot]
        ps = self.page_size
        k = one_cache["k"][:, row]
        v = one_cache["v"][:, row]
        L, S, N, hd = k.shape
        npg = min(-(-S // ps), self.pages_per_slot)
        idx = np.zeros(npg, np.int64)
        hi = min(len(pages), npg)
        idx[:hi] = pages[:hi]
        pad = npg * ps - S
        if pad > 0:
            k = torch.cat([k, k.new_zeros((L, pad, N, hd))], dim=1)
            v = torch.cat([v, v.new_zeros((L, pad, N, hd))], dim=1)
        kp = k[:, :npg * ps].reshape(L, npg, ps, N, hd)
        vp = v[:, :npg * ps].reshape(L, npg, ps, N, hd)
        dst = torch.from_numpy(idx).to(self.device)
        s0 = pool_scale(self.int_bits)
        self.cache["k_pages"][:, dst] = encode_pool(kp, self.int_bits)
        self.cache["v_pages"][:, dst] = encode_pool(vp, self.int_bits)
        # scales are (re)written with the codes, as in the reference
        self.cache["k_scale"][:, dst] = s0
        self.cache["v_scale"][:, dst] = s0

    # ------------------------------------------------------------ metrics
    def _page_bytes(self) -> int:
        return sum(t.element_size() * int(np.prod(t.shape[2:]))
                   for t in self.cache.values()) * self.cfg.n_layers

    def active_bytes(self, pages: Optional[int] = None) -> int:
        """Bytes resident for ``pages`` allocated pages (default: now)."""
        n = self.pages_in_use if pages is None else pages
        return n * self._page_bytes()

    def bytes_per_token(self) -> float:
        """Resident pool bytes per cached token (codes + per-page scales)."""
        return self._page_bytes() / self.page_size

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cache.values())
