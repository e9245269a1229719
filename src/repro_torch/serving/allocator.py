"""Page ownership for the serving pool: a refcounted free list.

PyTorch-side counterpart of ``repro.serving.allocator.PageAllocator``
(pure host bookkeeping over integer page ids). Pages are refcounted so
one physical page could back several owners; a page returns to the free
list only when its last owner lets go. The radix prefix cache that
shares pages between requests is not ported yet (ROADMAP.md section 1).
"""
from __future__ import annotations

from typing import List, Sequence


class PoolExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation right now (a transient
    condition: defer the request and retry once pages come back)."""


class PageAllocator:
    """Refcounted free-list allocator over page ids ``[reserved, num_pages)``.

    Ids below ``reserved`` (the scratch page) are never handed out. Freed
    pages return to the FRONT of the free list, so the next allocation
    reuses the hottest pages and reuse stays deterministic.
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages {num_pages} must exceed reserved {reserved}")
        self.num_pages = num_pages
        self.reserved = reserved
        self._refs = [0] * num_pages
        self._free: List[int] = list(range(reserved, num_pages))
        self._in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    @property
    def in_use(self) -> int:
        """Distinct pages with at least one owner."""
        return self._in_use

    def assert_drained(self) -> None:
        """Raise AssertionError unless every page is back on the free list."""
        leaked = [(p, self._refs[p]) for p in range(self.num_pages)
                  if self._refs[p] != 0]
        if leaked or self._in_use or len(self._free) != self.capacity:
            raise AssertionError(
                f"page pool not drained: in_use={self._in_use}, "
                f"free={len(self._free)}/{self.capacity}, "
                f"leaked refcounts={leaked[:16]}")

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list, each with refcount 1."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: need {n}, free {len(self._free)}")
        pages = self._free[:n]
        del self._free[:n]
        for p in pages:
            self._refs[p] = 1
        self._in_use += n
        return pages

    def unref(self, pages: Sequence[int]) -> List[int]:
        """Drop one owner per page; returns the truly freed subset."""
        freed: List[int] = []
        for p in pages:
            r = self._refs[p]
            if r <= 0:
                raise ValueError(f"unref of free page {p} (double free?)")
            self._refs[p] = r - 1
            if r == 1:
                freed.append(p)
        self._free[:0] = freed
        self._in_use -= len(freed)
        return freed
