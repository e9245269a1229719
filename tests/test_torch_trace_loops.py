"""Loops traced once and multiplied (``common.loops.trips`` under
``trace_cost.TraceCost``) against the trace of every iteration
(``unroll=True``), in steps of reduced configs on a traced (2, 2) mesh
(CPU, no process).

* 4 microbatches traced once and multiplied by 4: FLOPs, bytes,
  collective bytes and memory (temp and peak bytes) equal the trace of
  all 4, exactly (qwen2-1.5b, and olmoe-1b-7b, whose load-balancing loss
  all-reduces in its backward);
* the recurrent scans in a train step (S 6, one microbatch): rwkv6's
  WKV and Mamba2's per-step SSD (zamba2-7b with an SSD chunk of 4, which
  6 does not divide), traced for four steps and multiplied
  (``carry=True``): collective bytes equal; FLOPs and bytes within 1e-3,
  since the collapsed scan joins its outputs with one ``cat`` of an
  expanded view, whose backward sums the expansion where the unrolled
  ``stack``'s unbinds (measured at most 1.3e-4 and 8.9e-4 at S 24);
  temp and peak bytes within 1e-5 (measured equal at S 6, 5.5e-7 apart
  at S 24: the middle step's survivors count ``m - 4`` more times).
  Each case checks that the tracer did collapse a scan.

The scans of a prefill are ``test_torch_trace_prefill_scans.py``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distribution.sharding import Mesh
from repro_torch.launch import dryrun
from repro_torch.roofline import trace_cost

torch.set_num_threads(1)

MESH = Mesh((("data", 2), ("model", 2)))
#: the reduced configs whose scans collapse (zamba2: SSD chunks of 4)
SCAN_CFG = {"rwkv6-3b": {}, "zamba2-7b": {"ssm_chunk": 4}}
MEMORY = ("temp_bytes", "peak_bytes")


def _traces(arch, kind, S, m=None, monkeypatch=None):
    """(collapsed, unrolled) traces, and the (m, carry) of every loop the
    collapsed trace collapsed."""
    cfg = reduced(get_config(arch)).replace(**SCAN_CFG.get(arch, {}))
    seen = []
    if monkeypatch is not None:
        real = trace_cost.TraceCost._collapsed

        def spy(self, n, carry):
            seen.append((n, carry))
            return real(self, n, carry)
        monkeypatch.setattr(trace_cost.TraceCost, "_collapsed", spy)
    kw = {"num_microbatches": m} if m else {}
    got, want = (dryrun.trace_cell(cfg, ShapeConfig("t", S, 8, kind), MESH,
                                   unroll=u, **kw)[1]
                 for u in (False, True))
    return got, want, seen


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_one_microbatch_times_m_equals_all_m(arch):
    got, want, _ = _traces(arch, "train", 16, 4)
    assert (got.cost.flops, got.cost.bytes) == (want.cost.flops,
                                                want.cost.bytes)
    assert got.cost.coll_by_kind == want.cost.coll_by_kind
    assert got.memory == want.memory


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_collapsed_scans_equal_unrolled(arch, monkeypatch):
    got, want, seen = _traces(arch, "train", 6, 1, monkeypatch)
    assert (6, True) in seen
    assert got.cost.flops == pytest.approx(want.cost.flops, rel=1e-3, abs=0)
    assert got.cost.bytes == pytest.approx(want.cost.bytes, rel=1e-3, abs=0)
    assert got.cost.coll_by_kind == want.cost.coll_by_kind
    for k in MEMORY:
        assert got.memory[k] == pytest.approx(want.memory[k], rel=1e-5,
                                              abs=0), k
