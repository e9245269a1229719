"""Three-term roofline of one rank's traced step.

PyTorch counterpart of ``repro.roofline.analysis``:

  compute_t    = traced FLOPs (one rank's step)  / peak FLOP/s
  memory_t     = traced bytes                    / HBM bandwidth
  collective_t = collective operand bytes        / interconnect bandwidth

FLOPs, bytes and collective bytes come from
:mod:`repro_torch.roofline.trace_cost`, which costs a trace of the step
under ``FakeTensorMode`` (the reference's ``hlo_cost`` parses compiled
HLO, which the port does not have). ``torch_flops`` is
``FlopCounterMode``'s own count of the same trace (matmuls and
convolutions), kept as the cross-check field in the place of the
reference's ``xla_flops`` (XLA's ``cost_analysis()``).

The constants are the port's card, ``H100_SXM``; no TPU constant is here.
Caveat: ``collective_t`` divides by NVLink's 900 GB/s, which holds only
between the 8 cards of one node; a 256-card mesh crosses nodes, whose
links are slower, so on the production meshes it is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.roofline import trace_cost
from repro_torch.roofline.hardware import H100_SXM, HardwareProfile

# The card's constants under the reference's names (launch/dryrun.py
# reads HBM_BYTES for fits_hbm)
PEAK_FLOPS = H100_SXM.peak_flops      # bf16 dense
HBM_BW = H100_SXM.hbm_bw              # bytes/s
ICI_BW = H100_SXM.ici_bw              # bytes/s, NVLink 4 (one node)
HBM_BYTES = H100_SXM.mem_bytes        # the card's total memory


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    compute_t: float
    memory_t: float
    collective_t: float
    bottleneck: str
    peak_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    torch_flops: Optional[float] = None     # FlopCounterMode cross-check
    top_flops: Optional[List] = None        # [(label, flops)] attribution
    top_bytes: Optional[List] = None
    hw: Optional[str] = None                # hardware profile the times use

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(traced: trace_cost.Traced, *,
            model_flops_per_device: Optional[float] = None,
            keep_top: int = 8,
            hw: Optional[HardwareProfile] = None) -> Roofline:
    """model_flops_per_device: 6*N*D token-based FLOPs (global /
    n_devices). ``hw`` selects the envelope the time terms divide by
    (default ``H100_SXM``)."""
    prof = hw if hw is not None else H100_SXM
    cost = traced.cost
    flops, byts, cbytes = cost.flops, cost.bytes, cost.coll_bytes
    ct = flops / prof.peak_flops
    mt = byts / prof.hbm_bw
    lt = cbytes / prof.ici_bw
    bottleneck = max((("compute", ct), ("memory", mt), ("collective", lt)),
                     key=lambda kv: kv[1])[0]
    peak = float(traced.memory["peak_bytes"])
    ratio = (model_flops_per_device / flops
             if model_flops_per_device and flops else None)
    top = trace_cost.top_contributors(cost, keep_top)
    return Roofline(flops, byts, cbytes,
                    {k: int(v) for k, v in cost.coll_by_kind.items()},
                    ct, mt, lt, bottleneck, peak,
                    model_flops_per_device, ratio, traced.torch_flops,
                    top["flops"], top["bytes"], prof.name)


def model_flops(cfg, shape, n_devices: int) -> float:
    """6*N_active*D per step (train: 3x for fwd+bwd is folded into the 6;
    inference: 2*N*D per token + 2*attention read of the KV cache)."""
    from repro_torch.models import registry
    n_active = registry.param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def collective_bytes(traced: trace_cost.Traced) -> Dict[str, int]:
    """Collective operand bytes of a traced step, by kind."""
    return {k: int(v) for k, v in traced.cost.coll_by_kind.items()}
