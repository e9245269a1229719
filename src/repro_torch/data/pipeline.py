"""Deterministic, host-sharded synthetic LM data pipeline.

Production shape without the corpus: the pipeline yields token batches that
are (a) **deterministic in (seed, step)** — any host, any restart, any mesh
produces the same global batch, which is what makes checkpoint-resume and
elastic rescaling exact — and (b) **host-sharded** — each host materializes
only its slice of the global batch (`torch.distributed`-rank-aware), like a
tf.data/grain shard-by-process setup.

Two generators:

* ``synthetic``  — structured pseudo-text: a Zipf unigram backbone with
  planted bigram/trigram dependencies and repeated motifs, so a model
  trained on it has real signal to learn (loss decreases measurably, which
  the integration tests assert) and attention develops the concentrated
  score patterns HDP exploits.
* ``memorize``   — tiny fixed corpus cycled forever (overfit sanity checks).

The stateless ``batch_at(step)`` design (counter-based RNG, no generator
state to checkpoint) is the same trick production pipelines use for
reproducible restarts: the only data-state in a checkpoint is the step.

PyTorch-port copy of ``repro.data.pipeline`` (the sources are pure
numpy, so their batches are byte-equal to the reference's for every
(seed, step)); kept here so that the port imports nothing of the JAX
package. ``host_slice`` defaults to ``torch.distributed``'s rank and
world size when a process group is initialized, else (0, 1): the
counterparts of ``jax.process_index()`` and ``jax.process_count()``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | memorize
    zipf_a: float = 1.2              # unigram skew
    n_motifs: int = 64               # planted repeated phrases
    motif_len: int = 8
    motif_rate: float = 0.15         # fraction of positions starting a motif
    bigram_rate: float = 0.5         # P(next token forced by bigram table)


class SyntheticLM:
    """Counter-based deterministic synthetic LM stream.

    ``batch_at(step)`` is a pure function of (cfg.seed, step) — no internal
    state. Per-host slicing happens at the caller via ``host_slice``.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf unigram distribution over the vocab (stable across hosts).
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._unigram = p / p.sum()
        # Deterministic bigram successor table: token t -> successor(t).
        self._bigram = base.integers(0, v, size=v, dtype=np.int64)
        # Motif bank: short phrases that repeat verbatim (gives attention
        # long-range copy structure — the concentrated q-k pairs HDP prunes
        # toward).
        self._motifs = base.integers(
            0, v, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int64)

    def batch_at(self, step: int) -> np.ndarray:
        """Global batch [global_batch, seq_len] int32 for this step."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xDA7A]))
        B, S, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = rng.choice(v, size=(B, S), p=self._unigram).astype(np.int64)

        # Plant bigram dependencies: with prob bigram_rate, position i+1 is
        # the deterministic successor of position i.
        use_bg = rng.random((B, S - 1)) < cfg.bigram_rate
        for i in range(S - 1):
            nxt = self._bigram[toks[:, i]]
            toks[:, i + 1] = np.where(use_bg[:, i], nxt, toks[:, i + 1])

        # Plant motifs: overwrite a few spans with repeated phrases; the
        # same motif id repeats within a row (copy task).
        n_spans = max(1, int(S * cfg.motif_rate / cfg.motif_len))
        starts = rng.integers(0, max(S - cfg.motif_len, 1), size=(B, n_spans))
        motif_ids = rng.integers(0, cfg.n_motifs, size=(B,))
        for b in range(B):
            m = self._motifs[motif_ids[b]]
            for s0 in starts[b]:
                toks[b, s0:s0 + cfg.motif_len] = m[: S - s0]
        return toks.astype(np.int32)


class MemorizeLM:
    """Fixed tiny corpus, cycled — for overfit/regression tests."""

    def __init__(self, cfg: DataConfig, corpus_rows: int = 16):
        rng = np.random.default_rng(cfg.seed)
        self.cfg = cfg
        self._corpus = rng.integers(
            0, cfg.vocab_size, size=(corpus_rows, cfg.seq_len),
            dtype=np.int64).astype(np.int32)

    def batch_at(self, step: int) -> np.ndarray:
        B = self.cfg.global_batch
        n = self._corpus.shape[0]
        idx = (np.arange(B) + step * B) % n
        return self._corpus[idx]


def make_source(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "memorize":
        return MemorizeLM(cfg)
    raise ValueError(f"unknown data kind {cfg.kind!r}")


def host_slice(global_batch: int,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """Rows of the global batch this host materializes."""
    group = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if group else 0
    if process_count is None:
        process_count = dist.get_world_size() if group else 1
    pi, pc = process_index, process_count
    if global_batch % pc:
        # Uneven host split: host 0 takes the remainder (rare; documented).
        per = global_batch // pc
        extra = global_batch - per * pc
        start = pi * per + min(pi, extra)
        return slice(start, start + per + (1 if pi < extra else 0))
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


class Prefetcher:
    """Background-thread prefetch of host-local batches (depth-N pipeline).

    Overlaps the (numpy) batch synthesis/IO with device compute — the
    host-side half of compute/comm overlap. ``close()`` is idempotent.
    """

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 sl: Optional[slice] = None):
        self._source = source
        self._sl = sl if sl is not None else host_slice(
            source.cfg.global_batch)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)[self._sl]
            item = (step, {"tokens": batch})
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
