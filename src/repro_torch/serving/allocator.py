"""Page ownership for the serving pool: refcounts and the radix prefix
cache.

PyTorch-side counterpart of ``repro.serving.allocator`` (pure host
bookkeeping over integer page ids; the pool tensors and tables live in
``kv_cache.PagedKVCache``):

* ``PageAllocator`` — a refcounted free list. One physical page can back
  several owners (a decode slot, another slot admitted with the same
  prompt prefix, and the prefix cache itself); a page returns to the
  free list only when its last owner lets go, and only then does the
  ``on_free`` hook (the pool's NaN-poison debug hook) see it;
* ``RadixPrefixCache`` — a token-chunk radix tree from prompt prefixes
  to immutable full pages: each node holds one page worth of prompt
  tokens (the chunk tuple is the edge label) and the pool page holding
  that chunk's K/V. A resident node owns one allocator reference; a
  slot that matches a path takes one more per page. Under pool pressure
  the least recently used leaves whose pages no slot holds are evicted;
  interior nodes are pinned by construction, because a slot that holds
  a child page holds every ancestor page too.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.common.transient import TransientError


class PoolExhausted(TransientError):
    """The page pool cannot satisfy an allocation right now.

    A typed exhaustion signal, so that callers can tell recoverable
    pressure (defer the request, evict, retry next tick: what the stream
    scheduler's token-budget admission does) from genuine bugs that also
    surface as RuntimeError. It is a `TransientError`: retry layers may
    back off and try again."""


class PageAllocator:
    """Refcounted free-list allocator over page ids ``[reserved, num_pages)``.

    Ids below ``reserved`` (the scratch page) are never handed out. Freed
    pages return to the FRONT of the free list, so the next allocation
    reuses the hottest pages and reuse stays deterministic.
    ``on_free(pages)`` is called with each batch of truly freed ids
    (refcount reached 0).
    """

    def __init__(self, num_pages: int, reserved: int = 1,
                 on_free: Optional[Callable[[List[int]], None]] = None):
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages {num_pages} must exceed reserved {reserved}")
        self.num_pages = num_pages
        self.reserved = reserved
        self.on_free = on_free
        self._refs = [0] * num_pages
        self._free: List[int] = list(range(reserved, num_pages))
        self._in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Distinct pages with at least one owner (slot or cache)."""
        return self._in_use

    def refcount(self, page: int) -> int:
        return self._refs[page]

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

    def ref(self, pages: Sequence[int]) -> None:
        """Add one owner to each page (pages must be live)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"ref of free page {p}")
            self._refs[p] += 1

    def unref(self, pages: Sequence[int]) -> List[int]:
        """Drop one owner per page; returns the truly freed subset, which
        goes to the front of the free list and to ``on_free``."""
        freed: List[int] = []
        for p in pages:
            r = self._refs[p]
            if r <= 0:
                raise ValueError(f"unref of free page {p} (double free?)")
            self._refs[p] = r - 1
            if r == 1:
                freed.append(p)
        if freed:
            self._free[:0] = freed
            self._in_use -= len(freed)
            if self.on_free is not None:
                self.on_free(list(freed))
        return freed


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "last_use")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: "Optional[_Node]"):
        self.chunk = chunk
        self.page = page
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    """Token-chunk radix tree: prompt prefix -> immutable full pages.

    ``match`` walks the prompt in page-sized chunks and refs every page
    on the matched path for the caller (the admitting slot), so a
    matched page cannot be evicted before the slot releases it.
    ``insert`` registers a prefilled prompt's full pages, taking one
    cache reference per newly adopted page; chunks already resident keep
    their page (the newcomer's duplicate stays slot-owned and is not
    cached). ``evict`` frees least recently used unpinned leaves.
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size {page_size}")
        self.alloc = alloc
        self.page_size = page_size
        self._root = _Node((), -1, None)
        self._clock = 0
        self._nodes = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    @property
    def cached_pages(self) -> int:
        return self._nodes

    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(tokens[i * ps:(i + 1) * ps])

    def peek(self, tokens: Sequence[int], align: int = 1) -> int:
        """Pages on the longest cached prefix of ``tokens``, trimmed to a
        multiple of ``align``: a read-only probe (no references, counters
        or LRU clocks touched)."""
        node, n = self._root, 0
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            n += 1
            node = child
        return n - n % max(align, 1)

    def evictable_pages(self) -> int:
        """Pages ``evict`` could free now: a node is reclaimable iff no
        page in its subtree is held by a slot (refcount > 1)."""
        def walk(n: _Node) -> Tuple[int, bool]:
            cnt, blocked = 0, False
            for c in n.children.values():
                c_cnt, c_blk = walk(c)
                cnt += c_cnt
                blocked |= c_blk
            if blocked or self.alloc.refcount(n.page) > 1:
                return cnt, True
            return cnt + 1, False

        return sum(walk(c)[0] for c in self._root.children.values())

    def match(self, tokens: Sequence[int], align: int = 1) -> List[int]:
        """Longest cached prefix of ``tokens`` as page ids, trimmed to a
        multiple of ``align`` pages (HDP q-block alignment) before refs
        are taken and counters bumped (a match trimmed to nothing is a
        miss). Every returned page carries one fresh reference owned by
        the caller. Bumps the LRU clocks along the walked path."""
        self._clock += 1
        node, pages = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        pages = pages[:len(pages) - len(pages) % max(align, 1)]
        if pages:
            self.alloc.ref(pages)
            self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register ``pages`` as the full-page chain spelling ``tokens``:
        ``pages[i]`` holds the K/V of tokens ``[i*ps, (i+1)*ps)`` and is
        never written again by its owner. Returns the number of newly
        cached pages."""
        self._clock += 1
        node, added = self._root, 0
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            if pages[i] < self.alloc.reserved:
                # a scratch id here would serve staging garbage as
                # prompt K/V to every later hit
                raise ValueError(
                    f"cannot register reserved page {pages[i]} as a "
                    "prompt prefix")
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, pages[i], node)
                self.alloc.ref([pages[i]])
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            child.last_use = self._clock
            node = child
        return added

    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.alloc.refcount(n.page) == 1:   # the cache's ref only
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, least recently used leaves first;
        a leaf a slot still holds is skipped, and evicting a leaf may
        expose its parent, so the scan repeats until satisfied or dry."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_use)
            for leaf in leaves:
                leaf.parent.children.pop(leaf.chunk)
                self.alloc.unref([leaf.page])
                self._nodes -= 1
                self.evictions += 1
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def clear(self) -> int:
        """Drop every cached prefix (frees every cache-only page)."""
        n = self._nodes
        while self._nodes:
            if not self.evict(self._nodes):
                break
        return n - self._nodes
