"""The engine's prefill work for a request, worked out again from the
request alone and the engine's documented rules, for the reference.

* ``prefill_calls``: which forward calls prefilled a prompt. A cold
  prompt that fits the largest bucket is one call at the smallest bucket
  that holds it, padded with its last token; a longer one, and the
  suffix after a prefix-cache hit, is prefilled in chunks of the largest
  bucket at an offset, the last chunk padded to the smallest bucket that
  holds it and ends within ``max_len``.
* ``PrefixModel``: the prefix cache's pages as a radix tree of whole
  pages, each owned by the request that registered it first. A request
  registers the pages of its prompt before its last token once it is
  prefilled; a later request's hit is the longest chain of registered
  pages that spell its prompt, and each shared page's K/V is the owner's.
  Eviction is not modelled: the benchmark compares, step by step, the
  hit tokens this model predicts with the engine's own hit counter and
  leaves any request it cannot account for out of the check.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def tail_len(rem: int, off: int, buckets: Sequence[int], max_len: int) -> int:
    for b in buckets:
        if b >= rem and off + b <= max_len:
            return b
    return rem


def prefill_calls(prompt: np.ndarray, hit: int, buckets: Sequence[int],
                  max_len: int) -> List[Tuple[int, np.ndarray]]:
    """(offset, token ids) of every forward call that prefilled
    ``prompt`` after a hit of ``hit`` tokens."""
    buckets = sorted(buckets)
    plen = len(prompt)
    last = prompt[plen - 1]
    if hit == 0 and plen <= buckets[-1]:
        b = next(b for b in buckets if plen <= b)
        toks = np.full(b, last, np.int64)
        toks[:plen] = prompt
        return [(0, toks)]
    calls, off = [], hit
    while off < plen:
        rem = plen - off
        clen = buckets[-1] if rem >= buckets[-1] else \
            tail_len(rem, off, buckets, max_len)
        piece = np.full(clen, last, np.int64)
        piece[:min(rem, clen)] = prompt[off:off + clen]
        calls.append((off, piece))
        off += clen
    return calls


class PrefixModel:
    """Registered prompt pages: a tree keyed by each page's tokens, each
    node holding the uid of the request that registered it first."""

    def __init__(self, page: int):
        self.page = page
        self.root: Dict[bytes, list] = {}

    def _chunks(self, prompt: np.ndarray, n: int):
        ps = self.page
        for i in range(n):
            yield np.ascontiguousarray(prompt[i * ps:(i + 1) * ps]).tobytes()

    def match(self, prompt: np.ndarray) -> List[int]:
        """Owner uid of each page of the longest registered chain."""
        node, owners = self.root, []
        for key in self._chunks(prompt, len(prompt) // self.page):
            child = node.get(key)
            if child is None:
                break
            owners.append(child[0])
            node = child[1]
        return owners

    def register(self, uid: int, prompt: np.ndarray) -> None:
        """The pages strictly before the prompt's last position."""
        node = self.root
        for key in self._chunks(prompt, (len(prompt) - 1) // self.page):
            child = node.get(key)
            if child is None:
                child = node[key] = [uid, {}]
            node = child[1]


def shared_spans(owners: Sequence[int], page: int) -> List[Tuple[int, int, int]]:
    """Owner list per page -> (lo, hi, uid) spans of positions."""
    spans: List[Tuple[int, int, int]] = []
    for j, uid in enumerate(owners):
        if spans and spans[-1][2] == uid and spans[-1][1] == j * page:
            spans[-1] = (spans[-1][0], (j + 1) * page, uid)
        else:
            spans.append((j * page, (j + 1) * page, uid))
    return spans
