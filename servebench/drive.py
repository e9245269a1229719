"""The closed loop over the engine: warm-up, ramp, the measured window,
the drain, and the record of what the window saw.

The engine is driven through its public ``submit()`` and ``serve()``
(which steps it and yields each finished ``Result``); the benchmark's
own hook around ``step()`` reads the program's counters between steps:

* it opens the window once ``ramp_completions`` requests have finished,
  and closes it at the first step boundary ``seconds`` later; a request
  counts when its client sent it inside the window; once the window has
  closed the clients send nothing more, and the run ends when every
  counted request has finished (the drain);
* for every request the stream scheduler admitted in the step it works
  out the prefill the engine ran (``reference.replay``) and checks the
  step's prefix-hit tokens and prefill tokens against the engine's
  counters; a request of a step that does not add up is left out of the
  output check (``Record.accounted``);
* in a traced run it holds ``torch.profiler`` over a slice of
  ``slice_s`` seconds in the middle of the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from servebench.reference.replay import PrefixModel, prefill_calls
from servebench.traffic import Client, Traffic

#: uids of the warm-up requests start here; the load's count from 0
WARM_UID = 1 << 40


def read_pool(eng, slot: int, T: int, layers: int):
    """The int8 codes of a slot's K and V for positions [0, T) in the
    first ``layers`` layers, and their page scales (copies on the
    device)."""
    import torch
    c = eng.pages.cache
    if c["k_pages"].dtype != torch.int8:
        raise NotImplementedError("reading the pool needs int8 pages")
    ps = eng.pages.page_size
    pages = eng.pages.slot_pages(slot)[:-(-T // ps)]
    idx = torch.tensor(pages, dtype=torch.int64, device=c["k_pages"].device)

    def codes(name):
        g = c[name][:layers, idx]                # [layers, n, ps, N, hd]
        return g.reshape(layers, -1, *g.shape[3:])[:, :T].clone()

    return (codes("k_pages"), codes("v_pages"),
            c["k_scale"][:layers, idx].clone(),
            c["v_scale"][:layers, idx].clone())


@dataclasses.dataclass
class Record:
    """One request as the benchmark saw it."""
    uid: int
    client: int
    prompt: np.ndarray
    max_new: int
    t_submit: float
    counted: bool
    owners: Optional[List[int]] = None       # per shared page, its owner
    calls: Optional[list] = None             # the engine's prefill calls
    t_admit: Optional[float] = None
    accounted: bool = False
    result: object = None


@dataclasses.dataclass
class Window:
    """What a run measured; the metric readers take their numbers here."""
    seconds: float
    setup_s: float
    m0: Dict
    m1: Dict
    hit0: int
    hit1: int
    records: Dict[int, Record]
    t_start: float
    t_end: float
    page: int
    conf: Dict
    trace: Optional[Dict] = None
    kind: str = ""
    card: str = ""

    @property
    def counted(self) -> List[Record]:
        return [r for r in self.records.values() if r.counted]

    @property
    def admitted(self) -> List[Record]:
        """Requests whose prefill the engine began inside the window."""
        return [r for r in self.records.values() if r.t_admit is not None
                and self.t_start <= r.t_admit < self.t_end]

    def hit_tokens(self, r: Record) -> int:
        return len(r.owners or ()) * self.page

    def delta(self, key: str) -> float:
        return self.m1[key] - self.m0[key]


class Load:
    """One run's load on one engine."""

    def __init__(self, eng, traffic_spec: Dict, conf: Dict, seed: int,
                 seconds: float, slice_s: Optional[float] = None,
                 capture: Optional[Dict] = None):
        self.eng = eng
        self.spec = traffic_spec
        self.conf = conf
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.slice_s = slice_s
        e = conf["engine"]
        self.buckets = sorted(e["prefill_buckets"])
        self.max_len = e["max_len"]
        self.page = eng.pages.page_size
        self.model = PrefixModel(self.page) if eng.prefix is not None \
            else None
        self.traffic = Traffic(traffic_spec, conf["model"]["vocab_size"],
                               seed)
        self.records: Dict[int, Record] = {}
        self._n_adm = len(eng.sched.admitted_uids)
        self._snap = self._counters()
        self.completions = 0
        self.t_start = self.t_end = None
        self.m0 = self.m1 = None
        self.hit0 = self.hit1 = 0
        self.open_counted = 0
        self.unaccounted = 0
        self.prof = None
        self.prof_t = None
        self.trace_steps = None
        #: pool reads of finished requests (``capture``: the layers to
        #: read, the share of counted requests drawn, the served tokens
        #: wanted): uid -> read_pool(...); the longest counted request is
        #: always read, the drawn ones until the tokens are reached
        self.capture = capture if capture is not None else \
            {"layers": eng.cfg.n_layers, "share": 0.3, "tokens": 400}
        self.pool: Dict[int, tuple] = {}
        self.drawn: List[int] = []
        self.drawn_tokens = 0
        self.longest: Optional[int] = None

    # ------------------------------------------------------------ counters
    def _hits(self) -> int:
        return self.eng.prefix.hit_tokens if self.eng.prefix is not None \
            else 0

    def _counters(self):
        m = self.eng.metrics
        return (self._hits(), m["prefill_tokens"], m["sched_chunk_tokens"])

    def _account(self, now: float) -> None:
        """Work out the prefill of the step's admissions and check it
        against the engine's counters."""
        adm = self.eng.sched.admitted_uids
        new = [u for u in adm[self._n_adm:] if u in self.records]
        warm = len(adm) - self._n_adm - len(new)
        self._n_adm = len(adm)
        snap = self._counters()
        d_hit = snap[0] - self._snap[0]
        d_tok = (snap[1] - self._snap[1]) - (snap[2] - self._snap[2])
        self._snap = snap
        want_hit = want_tok = 0
        for uid in new:
            r = self.records[uid]
            r.t_admit = now
            r.owners = self.model.match(r.prompt) if self.model else []
            hit = len(r.owners) * self.page
            r.calls = prefill_calls(r.prompt, hit, self.buckets, self.max_len)
            want_hit += hit
            if not (hit == 0 and len(r.prompt) > self.buckets[-1]):
                want_tok += sum(len(t) for _, t in r.calls)
        if self.model is not None:
            for uid in new:
                self.model.register(uid, self.records[uid].prompt)
        ok = warm == 0 and d_hit == want_hit and d_tok == want_tok
        for uid in new:
            self.records[uid].accounted = ok
        if not ok:
            self.unaccounted += len(new)

    def _size(self, uid: int) -> int:
        r = self.records[uid]
        return len(r.prompt) + r.max_new

    def _on_finish(self, slot: int, status: str) -> None:
        """Before the engine releases a finished request's pages: read them
        if the request is drawn for the check or the longest so far."""
        st = self.eng._active.get(slot)
        if st is None or status != "ok":
            return
        uid = st["req"].uid
        r = self.records.get(uid)
        if r is None or not r.counted:
            return
        cap = self.capture
        rng = np.random.default_rng([self.seed, 4, uid])
        drawn = rng.random() < cap["share"] and \
            self.drawn_tokens < cap["tokens"]
        longest = self.longest is None or \
            (self._size(uid), -uid) > (self._size(self.longest), -self.longest)
        if not (drawn or longest):
            return
        T = len(r.prompt) - 1 + len(st["generated"])
        self.pool[uid] = read_pool(self.eng, slot, T, cap["layers"])
        if drawn:
            self.drawn.append(uid)
            self.drawn_tokens += len(st["generated"])
        if longest:
            if self.longest is not None and self.longest not in self.drawn:
                self.pool.pop(self.longest, None)
            self.longest = uid

    # ----------------------------------------------------------- the loop
    def _submit(self, client: int, c: Client, now: float) -> None:
        from repro_torch.serving import Request
        t = c.next()
        uid = len(self.records)
        counted = self.t_start is not None and self.t_end is None
        self.records[uid] = Record(uid, client, t.prompt, t.max_new, now,
                                   counted)
        if counted:
            self.open_counted += 1
        self.eng.submit(Request(uid, t.prompt.tolist(), max_new_tokens=t.max_new))

    def _on_step(self) -> None:
        import torch
        now = time.perf_counter()
        self._account(now)
        if self.t_start is None:
            if self.completions >= self.spec["ramp_completions"]:
                self.t_start = now
                self.m0, self.hit0 = dict(self.eng.metrics), self._hits()
        elif self.t_end is None and now >= self.t_start + self.seconds:
            self.t_end = now
            self.m1, self.hit1 = dict(self.eng.metrics), self._hits()
        if self.slice_s is None or self.t_start is None:
            return
        mid = self.t_start + 0.5 * (self.seconds - self.slice_s)
        if self.prof is None and now >= mid:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t = [time.perf_counter(), None]
            self.trace_steps = [self.eng.metrics["decode_steps"], None]
        elif self.prof_t is not None and self.prof_t[1] is None \
                and now >= self.prof_t[0] + self.slice_s:
            torch.cuda.synchronize()
            self.prof_t[1] = time.perf_counter()
            self.prof.stop()
            self.trace_steps[1] = self.eng.metrics["decode_steps"]

    def run(self, t_process: float, drain_s: float = 120.0) -> Window:
        eng = self.eng
        clients = [Client(self.traffic, i) for i in range(self.spec["clients"])]
        plain_step = eng.step

        def step():
            n = plain_step()
            self._on_step()
            return n

        eng.step = step
        plain_finish = eng._finish

        def finish(slot, now=None, *, status="ok", error=None):
            self._on_finish(slot, status)
            return plain_finish(slot, now, status=status, error=error)

        eng._finish = finish
        try:
            now = time.perf_counter()
            for i, c in enumerate(clients):
                self._submit(i, c, now)
            for res in eng.serve(max_steps=1 << 62):
                r = self.records.get(res.uid)
                if r is None:
                    continue
                r.result = res
                self.completions += 1
                if r.counted:
                    self.open_counted -= 1
                if self.t_end is not None and self.open_counted == 0:
                    break
                if self.t_end is not None:
                    if time.perf_counter() > self.t_end + drain_s:
                        break
                    continue
                self._submit(r.client, clients[r.client], time.perf_counter())
        finally:
            eng.__dict__.pop("step", None)
            eng.__dict__.pop("_finish", None)
        return Window(self.t_end - self.t_start, self.t_start - t_process,
                      self.m0, self.m1, self.hit0, self.hit1, self.records,
                      self.t_start, self.t_end, self.page, self.conf)


def warm_up(eng, conf: Dict, traffic_spec: Dict, seed: int) -> None:
    """Run every prefill shape the cell's traffic takes once, and the
    decode graph's capture: one request at each bucket's length, and one
    past the largest bucket (the chunked path) where the mix sends such
    prompts; each decodes past one horizon."""
    from repro_torch.serving import Request
    from servebench.traffic import longest_request
    e = conf["engine"]
    buckets = sorted(e["prefill_buckets"])
    lens = list(buckets)
    longest = longest_request(traffic_spec) - traffic_spec["answer_len"]["max"]
    if longest > buckets[-1]:
        lens.append(min(longest, e["max_len"] - 2 * e["decode_horizon"] - 1))
    rng = np.random.default_rng([int(seed), 0])
    vocab = conf["model"]["vocab_size"]
    for i, n in enumerate(lens):
        eng.submit(Request(WARM_UID + i, rng.integers(0, vocab, n).tolist(),
                           max_new_tokens=2 * e["decode_horizon"] + 1))
    eng.run()
