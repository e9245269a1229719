"""Cost-driven attention-backend chooser with a measured-fallback cache.

PyTorch counterpart of ``repro.autotune.tuner``. :class:`Tuner` is
consulted by ``repro_torch.attention.resolve_backend`` when the
effective selection policy is ``"cost"``: for every distinct
:class:`~repro_torch.autotune.cost.CallSig` it ranks the supporting
backends by predicted step time (:func:`repro_torch.autotune.cost.predict`,
under the device's :class:`~repro_torch.roofline.hardware.HardwareProfile`
and the measured sparsity EMA) and returns the winner.

Where the reference consults the tuner once per jit trace, the port
consults it on every eager dispatch, and on the warm-up and the capture
of a CUDA graph (a replay consults nothing: the choice is burnt into the
captured kernels). The decisions, the pending probes, the probes run
and the measured cache are the reference's; ``hits``/``misses`` count
consultations, so they count more of them than the reference's
trace-time counters do.

* A close call (top-2 within ``margin``) is not timed inline. It is
  recorded as a *pending probe*; :meth:`flush_probes` — called host-side
  by the engine between steps (never inside a graph capture) and on
  scheduler slot recycles — times the two candidates on synthetic inputs
  of the same signature, on the profile's device, and remembers the
  winner in the measured cache. A flipped decision bumps the engine's
  attention epoch, which drops its captured graphs, so the next step
  re-captures and re-consults the tuner.
* The probe builds fp32 K/V pools whatever the serving pool's format, as
  the reference's does: on the card it times the FUM kernel's
  unquantized-pool path (ROADMAP.md section 3).

The measured cache is serializable (:meth:`save`/:meth:`load`, JSON
keyed on ``CallSig.key()``, the reference's format) so serve runs
warm-start: a loaded cache answers every previously-probed signature
without re-timing. ``REPRO_TUNER_CACHE`` names a warm-start path for the
process-default tuner.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.autotune.cost import (CallSig, CostEstimate,
                                       SparsityEstimate, predict)
from repro_torch.roofline.hardware import HardwareProfile, detect_profile

#: env var naming a JSON warm-start cache for the process-default tuner.
TUNER_CACHE_ENV = "REPRO_TUNER_CACHE"

_CACHE_VERSION = 1


class Tuner:
    """Per-signature backend chooser: predict, probe on ambiguity, remember.

    Parameters
    ----------
    hw: hardware profile for predictions (default: ``detect_profile()``,
        the card when CUDA is available, else the CPU). Probes run on
        the card when the profile runs the kernels natively, else on the
        CPU.
    margin: relative predicted-time band treated as ambiguous — first
        sighting of such a signature schedules a one-time probe of the
        top-2 candidates.
    probe_reps: timed repetitions per probed candidate (min is taken;
        one untimed warm-up call builds and loads the kernel first).
    cache_path: JSON measured-cache to warm-start from (best effort —
        a missing or unreadable file starts cold).
    """

    def __init__(self, hw: Optional[HardwareProfile] = None, *,
                 margin: float = 0.25, probe_reps: int = 3,
                 cache_path: Optional[str] = None):
        self.hw = hw if hw is not None else detect_profile()
        self.margin = float(margin)
        self.probe_reps = int(probe_reps)
        #: probed ground truth: sig key -> winning backend name
        self.measured: Dict[str, str] = {}
        #: current choice per sig key (measured if present, else predicted)
        self.decision: Dict[str, str] = {}
        #: predicted CostEstimate per candidate per sig key
        self.estimates: Dict[str, Dict[str, CostEstimate]] = {}
        self.sig_by_key: Dict[str, CallSig] = {}
        #: ambiguous first sightings awaiting a host-side probe:
        #: key -> (AttnCall, CallSig, top-2 backend names)
        self.pending: Dict[str, Tuple] = {}
        #: per probed key, each candidate's best time (s), in probe order
        self.probe_times: Dict[str, Dict[str, float]] = {}
        self.hits = 0
        self.misses = 0
        self.probes = 0
        self._sparsity: Optional[SparsityEstimate] = None
        if cache_path:
            self.load(cache_path)

    @property
    def device(self) -> torch.device:
        """Where probes run: the card for a profile that runs the kernels
        natively, else the CPU."""
        return torch.device("cuda" if self.hw.pallas_native else "cpu")

    # ------------------------------------------------------------ sparsity
    def observe_sparsity(self, block: float, head: float, page: float,
                         beta: float = 0.8) -> None:
        """Fold one engine stats sample into the sparsity EMA."""
        new = SparsityEstimate(block, head, page).clamped()
        old = self._sparsity
        if old is None:
            self._sparsity = new
        else:
            mix = lambda a, b: beta * a + (1 - beta) * b  # noqa: E731
            self._sparsity = SparsityEstimate(
                mix(old.block, new.block), mix(old.head, new.head),
                mix(old.page, new.page))

    def sparsity_for(self, sig: CallSig) -> SparsityEstimate:
        if not sig.hdp:
            return SparsityEstimate()
        return self._sparsity if self._sparsity is not None \
            else SparsityEstimate.prior(sig)

    # -------------------------------------------------------------- choose
    def choose(self, call, sig: CallSig, cands: List):
        """Pick the backend serving ``call`` among ``cands`` (at dispatch).

        Returns a registry ``Backend``. Measured winners take precedence;
        otherwise the predicted-fastest candidate wins and an ambiguous
        first sighting is queued for a one-time probe.
        """
        key = sig.key()
        self.sig_by_key[key] = sig
        by_name = {b.name: b for b in cands}
        sp = self.sparsity_for(sig)
        ests = {b.name: predict(b.name, sig, self.hw, sp) for b in cands}
        self.estimates[key] = ests
        meas = self.measured.get(key)
        if meas is not None and meas in by_name:
            self.hits += 1
            self.decision[key] = meas
            return by_name[meas]
        self.misses += 1
        ranked = sorted(cands,
                        key=lambda b: (ests[b.name].step_time(self.hw),
                                       b.name))
        best = ranked[0]
        if len(ranked) > 1 and key not in self.pending:
            t1 = ests[ranked[0].name].step_time(self.hw)
            t2 = ests[ranked[1].name].step_time(self.hw)
            if t2 <= t1 * (1.0 + self.margin):
                self.pending[key] = (call, sig, (ranked[0].name,
                                                 ranked[1].name))
        self.decision[key] = best.name
        return best

    # -------------------------------------------------------------- probes
    def flush_probes(self) -> bool:
        """Run every pending probe (host side, synthetic inputs).

        Returns True when any measured winner differs from the standing
        predicted decision — the caller's cue to bump its attention
        epoch so the next step re-consults the tuner.
        """
        if not self.pending:
            return False
        changed = False
        for key, (call, sig, names) in list(self.pending.items()):
            try:
                winner = self._probe(call, sig, names)
            except Exception:
                # a probe failure must never take serving down; keep the
                # predicted decision and stop re-trying this signature
                del self.pending[key]
                continue
            del self.pending[key]
            self.measured[key] = winner
            self.probes += 1
            if self.decision.get(key) != winner:
                self.decision[key] = winner
                changed = True
        return changed

    @torch.no_grad()
    def _probe(self, call, sig: CallSig, names) -> str:
        """Time each candidate on synthetic inputs; fastest wins. Each
        candidate runs once untimed (on the card: builds and loads its
        kernel), then ``probe_reps`` times, synchronized around each
        timed run; its time is the minimum. The candidates' times land
        in ``probe_times``."""
        from repro_torch.attention.registry import get_backend
        from repro_torch.distribution.tp import agreed_floats

        dev = self.device
        q, k, v, cache, table, q_pos, k_pos = _synthetic_inputs(call, sig,
                                                                dev)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        times: Dict[str, float] = {}
        best_name, best_t = None, None
        for name in names:
            backend = get_backend(name)

            def run(_b=backend):
                return _b.run(q, k, v, call, q_pos=q_pos, k_pos=k_pos,
                              cache=cache, page_table=table)[0]

            run()                       # build + warm
            sync()
            t_min = None
            for _ in range(self.probe_reps):
                t0 = time.perf_counter()
                run()
                sync()
                dt = time.perf_counter() - t0
                t_min = dt if t_min is None else min(t_min, dt)
            times[name] = t_min
        # under tensor-parallel serving every rank takes the first rank's
        # times, so that all of them pick the same winner
        times = dict(zip(times, agreed_floats(list(times.values()))))
        for name, t in times.items():
            if best_t is None or t < best_t:
                best_name, best_t = name, t
        self.probe_times[sig.key()] = times
        return best_name

    # ------------------------------------------------------------ reporting
    def decision_for(self, call) -> Optional[str]:
        """Standing decision whose signature matches ``call``'s phase
        (mode / layout / draft / verify), or None before any dispatch."""
        want = (call.mode, call.layout, call.draft is not None, call.verify)
        for key in reversed(list(self.decision)):
            sig = self.sig_by_key.get(key)
            if sig is None:
                continue
            if (sig.mode, sig.layout, sig.draft != "", sig.verify) == want:
                return self.decision[key]
        return None

    def estimate_for(self, call) -> Optional[Tuple[str, CostEstimate]]:
        """(chosen backend, its CostEstimate) for ``call``'s phase."""
        want = (call.mode, call.layout, call.draft is not None, call.verify)
        for key in reversed(list(self.decision)):
            sig = self.sig_by_key.get(key)
            if sig is None:
                continue
            if (sig.mode, sig.layout, sig.draft != "", sig.verify) == want:
                name = self.decision[key]
                est = self.estimates.get(key, {}).get(name)
                if est is not None:
                    return name, est
        return None

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "probes": self.probes, "pending": len(self.pending),
                "measured": len(self.measured)}

    # -------------------------------------------------------- serialization
    def save(self, path: str) -> None:
        data = {"version": _CACHE_VERSION, "hw": self.hw.name,
                "measured": dict(self.measured)}
        with open(path, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")

    def load(self, path: str) -> bool:
        """Merge a saved measured cache (same hardware profile only)."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        if data.get("version") != _CACHE_VERSION \
                or data.get("hw") != self.hw.name:
            return False
        self.measured.update(data.get("measured") or {})
        return True


def _synthetic_inputs(call, sig: CallSig, device="cpu"):
    """(q, k, v, cache, table, q_pos, k_pos) matching ``sig``'s shapes,
    on ``device``, from the reference's numbers (``default_rng(0)``, the
    same draws in the same order), so both packages probe alike.

    Mirrors the serving layout contracts: paged pools are the per-call
    [P, ps, N, hd] views with page 0 as scratch and tables pointing at
    pages 1..; per-slot position arrays carry the batch dim with -1
    marking invalid columns. The pools are fp32 whatever the serving
    pool's format, as in the reference.
    """
    rng = np.random.default_rng(0)
    B, N, G, Sq, hd = (sig.batch, sig.n_kv_heads, sig.group, sig.sq, sig.hd)
    kv = sig.kv_len

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q = dev(rng.standard_normal((B, N, G, Sq, hd)).astype(np.float32))
    k_host = rng.standard_normal((B, kv, N, hd)).astype(np.float32)
    v_host = rng.standard_normal((B, kv, N, hd)).astype(np.float32)
    last = kv - 1
    pos = torch.arange(kv - Sq, kv, dtype=torch.int32,
                       device=device)[None, :].repeat(B, 1)
    ar = torch.arange(kv, dtype=torch.int32, device=device)
    if sig.per_slot:
        q_pos = pos[:, None, None, :]
        k_pos = torch.where(ar[None, :] <= last, ar[None, :], -1)
        k_pos = k_pos[:, None, None, :].repeat(B, 1, 1, 1)
    else:
        q_pos = pos[0]
        k_pos = ar

    if call.layout != "paged":
        return q, dev(k_host), dev(v_host), None, None, q_pos, k_pos

    from repro_torch.models.attention import scout_frac_int8, scout_int8

    ps = sig.page_size
    n_pages = kv // ps
    P = B * n_pages + 1                     # + scratch page 0
    k_pages = np.zeros((P, ps, N, hd), np.float32)
    v_pages = np.zeros((P, ps, N, hd), np.float32)
    k_pages[1:] = k_host.reshape(B * n_pages, ps, N, hd)
    v_pages[1:] = v_host.reshape(B * n_pages, ps, N, hd)
    cache = {"k_pages": dev(k_pages), "v_pages": dev(v_pages)}
    if call.hdp is not None:
        k_t = dev(k_host)
        sc = torch.zeros((P, ps, N, hd), dtype=torch.int8, device=device)
        sc[1:] = scout_int8(k_t, call.hdp).reshape(B * n_pages, ps, N, hd)
        cache["k_scout"] = sc
        if call.draft is not None and call.draft.scores == "scout":
            fc = torch.zeros((P, ps, N, hd), dtype=torch.int8,
                             device=device)
            fc[1:] = scout_frac_int8(k_t, call.hdp).reshape(
                B * n_pages, ps, N, hd)
            cache["f_scout"] = fc
    table = torch.arange(1, B * n_pages + 1, dtype=torch.int32,
                         device=device).reshape(B, n_pages)
    return q, None, None, cache, table, q_pos, k_pos


# ------------------------------------------------------- process default
_DEFAULT: Optional[Tuner] = None


def default_tuner(device=None) -> Tuner:
    """The process-wide tuner cost-policy dispatch consults (lazy).

    Made on first use with the profile of ``device``
    (``detect_profile(device)``; the engine passes its own) and honors
    ``REPRO_TUNER_CACHE`` for warm-start. Engines running under
    ``policy="cost"`` share it — measured winners and the sparsity EMA
    carry across engines in one process. Install one with
    :func:`set_default_tuner`, clear it with :func:`reset_default_tuner`.
    """
    global _DEFAULT
    if _DEFAULT is None:
        path = os.environ.get(TUNER_CACHE_ENV, "").strip() or None
        _DEFAULT = Tuner(detect_profile(device), cache_path=path)
    return _DEFAULT


def set_default_tuner(tuner: Optional[Tuner]) -> None:
    global _DEFAULT
    _DEFAULT = tuner


def reset_default_tuner() -> None:
    set_default_tuner(None)
