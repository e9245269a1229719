"""A world of local ranks that runs functions SPMD over gloo.

``LocalWorld(n, store_dir)`` spawns ``n`` processes that join one gloo
process group through a ``FileStore`` in ``store_dir`` (no port to
collide on), each with a collective timeout. ``run(fn, *args)`` calls
``fn(*args)`` on every rank at once and returns the ranks' results in
rank order; ``fn`` must be importable by name (a module-level
function), and so must its arguments and result be picklable.

A rank that raises, or a call that outlives its deadline (twice the
collective timeout), tears the whole world down (every rank terminated)
and raises here, so a parted rank fails one call instead of stalling
its caller; the next ``run`` spawns a fresh world. Each rank runs one
intra-op thread. ``close`` ends the ranks, joining them with a
deadline and terminating what is left.

    with LocalWorld(2, tmp_dir) as world:
        tokens = world.run(serve_fn, tp=2)     # [rank 0's, rank 1's]
"""
from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
from typing import Any, Callable, List

#: seconds a rank's collective waits for the others before it raises
TIMEOUT_S = 60.0


def _rank_main(rank: int, world: int, store_path: str, inbox,
               outbox) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args, kw = task
            try:
                outbox.put((rank, True, fn(*args, **kw)))
            except Exception:  # noqa: BLE001 - reported to the caller
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalWorld:
    """``n`` local ranks in one gloo process group (see module doc)."""

    def __init__(self, n: int, store_dir: str):
        if n < 1:
            raise ValueError(f"a world needs at least one rank, got {n}")
        self.n = n
        self.store_dir = str(store_dir)
        self._procs: List[Any] = []
        self._spawns = 0

    def _spawn(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._spawns += 1
        store = os.path.join(self.store_dir, f"store{self._spawns}")
        self._inboxes = [ctx.Queue() for _ in range(self.n)]
        self._outbox = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, store, self._inboxes[r],
                              self._outbox))
            for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kw) -> list:
        """``fn(*args, **kw)`` on every rank; the results by rank. Raises
        RuntimeError (after tearing the world down) when a rank raises or
        dies, or when twice the collective timeout passes first."""
        if not self._procs:
            self._spawn()
        for q in self._inboxes:
            q.put((fn, args, kw))
        deadline = time.monotonic() + 2 * TIMEOUT_S
        out: List[Any] = [None] * self.n
        pending = set(range(self.n))
        while pending:
            try:
                rank, ok, val = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close(grace_s=0.0)
                    why = (f"rank(s) {dead} died" if dead else
                           f"deadline of {2 * TIMEOUT_S} s passed")
                    raise RuntimeError(f"{getattr(fn, '__name__', fn)}: "
                                       f"{why} with rank(s) {sorted(pending)}"
                                       " unfinished")
                continue
            if not ok:
                self.close(grace_s=0.0)
                raise RuntimeError(f"rank {rank} raised in "
                                   f"{getattr(fn, '__name__', fn)}:\n{val}")
            out[rank] = val
            pending.discard(rank)
        return out

    def close(self, grace_s: float = 10.0) -> None:
        """End every rank: ask, join within ``grace_s``, terminate the
        rest."""
        if not self._procs:
            return
        if grace_s > 0:
            for q in self._inboxes:
                q.put(None)
        end = time.monotonic() + grace_s
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for q in self._inboxes + [self._outbox]:
            q.cancel_join_thread()
            q.close()
        self._procs = []

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
