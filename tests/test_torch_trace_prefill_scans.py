"""Scans of a prefill traced collapsed (``common.loops.trips(m,
carry=True)`` under ``trace_cost.TraceCost``: four steps, the middle one
counting ``m - 3`` times) against the trace of every step
(``unroll=True``), on a traced (2, 2) mesh (reduced configs, CPU, no
process): rwkv6's WKV over 24 steps and Mamba2's chunked SSD over 5
chunks of 4 (zamba2-7b, S 20). FLOPs, bytes, collective bytes and memory
equal exactly (measured).

Without a backward a step leaves only its output alive until the scan
joins them, and the prefill's peak falls where the projections are live
(the same with the middle step's survivors counted ``m - 4`` more times
or not). What these cases hold is that nothing else is counted as a
survivor: matched by storage id alone (ids are reused once a storage is
freed), rwkv6's case counts freed storages again and fails. The train
scans, whose survivors (the tensors saved for the backward) reach the
peak, are ``test_torch_trace_loops.py``. Each case checks that the
tracer did collapse the scan.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_trace_loops import _traces

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,S,trips", [("rwkv6-3b", 24, 24),
                                          ("zamba2-7b", 20, 5)])
def test_collapsed_prefill_scans_equal_unrolled(arch, S, trips, monkeypatch):
    got, want, seen = _traces(arch, "prefill", S, monkeypatch=monkeypatch)
    assert (trips, True) in seen
    assert (got.cost.flops, got.cost.bytes) == (want.cost.flops,
                                                want.cost.bytes)
    assert got.cost.coll_by_kind == want.cost.coll_by_kind
    assert got.memory == want.memory
