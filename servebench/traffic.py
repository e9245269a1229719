"""One general generator of closed-loop session traffic, driven by the
parameters of a traffic file (``servebench/traffic/<name>.json``).

A mix is a set of clients, each running sessions back to back with no
think time. A session has an optional shared prefix (a document) and
``turns`` requests in turn, each sent after the previous answer came
back: prompt = prefix + that turn's own tokens, answer = a token budget
with no end-of-sequence token, so every answer runs to its budget.

The sizes (prefix, per-turn prompt and answer lengths) of a pool of
sessions, and the order the pool is handed out in (a new permutation
each time it is used up), come from the file's fixed ``sizes_seed``:
every run seed serves the same sessions' sizes in the same order, so a
window's work does not change with the seed. The run's ``--seed`` draws
the token ids, uniformly from the vocabulary. Session ``k``'s tokens
depend only on the seed and ``k``, so the same seed gives the same
requests whatever the timing; which client serves session ``k`` depends
on timing.

With ``stagger_turns`` client ``c``'s first session starts at turn
``c % turns`` (cold, as any first turn), so the clients do not move
through their sessions in step.

Length distributions: ``{"dist": "uniform", "min", "max"}`` (whole
numbers, both ends included) or ``{"dist": "lognormal", "median",
"sigma", "min", "max"}`` (rounded, clipped).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def draw_len(spec: Optional[Dict], rng: np.random.Generator) -> int:
    if spec is None:
        return 0
    if spec["dist"] == "uniform":
        return int(rng.integers(spec["min"], spec["max"] + 1))
    if spec["dist"] == "lognormal":
        x = spec["median"] * float(np.exp(spec["sigma"] * rng.standard_normal()))
        return int(np.clip(round(x), spec["min"], spec["max"]))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


@dataclasses.dataclass(frozen=True)
class SessionSizes:
    prefix: int
    prompts: tuple
    answers: tuple


@dataclasses.dataclass
class Turn:
    """One request of a session: its prompt and answer budget."""
    session: int
    turn: int
    prompt: np.ndarray
    max_new: int


def size_pool(spec: Dict) -> List[SessionSizes]:
    rng = np.random.default_rng(spec["sizes_seed"])
    pool = []
    for _ in range(spec["pool"]):
        prefix = draw_len(spec.get("shared_len"), rng)
        prompts = tuple(draw_len(spec["prompt_len"], rng)
                        for _ in range(spec["turns"]))
        answers = tuple(draw_len(spec["answer_len"], rng)
                        for _ in range(spec["turns"]))
        pool.append(SessionSizes(prefix, prompts, answers))
    return pool


def longest_request(spec: Dict) -> int:
    """Prompt plus answer of the longest request the mix can send."""
    pre = spec.get("shared_len")
    return (pre["max"] if pre else 0) + spec["prompt_len"]["max"] \
        + spec["answer_len"]["max"]


class Traffic:
    """The session stream of one run: ``session(k)`` is the k-th session
    handed out; ``Client`` walks a client through its sessions."""

    def __init__(self, spec: Dict, vocab: int, seed: int):
        self.spec = spec
        self.vocab = vocab
        self.seed = int(seed)
        self.pool = size_pool(spec)
        self._order: List[int] = []
        self.handed = 0

    def _sizes(self, k: int) -> SessionSizes:
        n = len(self.pool)
        while len(self._order) <= k:
            cycle = len(self._order) // n
            rng = np.random.default_rng([self.spec["sizes_seed"], 1, cycle])
            self._order.extend(rng.permutation(n).tolist())
        return self.pool[self._order[k]]

    def session(self, k: int) -> List[Turn]:
        sz = self._sizes(k)
        rng = np.random.default_rng([self.seed, 2, k])
        prefix = rng.integers(0, self.vocab, sz.prefix, dtype=np.int64)
        turns = []
        for t, (pl, al) in enumerate(zip(sz.prompts, sz.answers)):
            own = rng.integers(0, self.vocab, pl, dtype=np.int64)
            turns.append(Turn(k, t, np.concatenate([prefix, own]), al))
        return turns

    def next_session(self) -> List[Turn]:
        k = self.handed
        self.handed += 1
        return self.session(k)


class Client:
    """One closed-loop client: ``next()`` is the request it sends now."""

    def __init__(self, traffic: Traffic, index: int):
        self.traffic = traffic
        turns = traffic.next_session()
        skip = index % len(turns) if traffic.spec.get("stagger_turns") else 0
        self._queue = turns[skip:]

    def next(self) -> Turn:
        if not self._queue:
            self._queue = self.traffic.next_session()
        return self._queue.pop(0)
