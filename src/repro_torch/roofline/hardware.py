"""Hardware profiles for cost-model predictions.

PyTorch counterpart of ``repro.roofline.hardware``: the same
:class:`HardwareProfile` fields and the same ``HOST_CPU`` envelope, so a
cost term reads alike in both packages and a decision made on the CPU
equals the reference's. The port's card profile is ``H100_SXM`` (the
reference's is a TPU's; no TPU profile lives here).
:func:`detect_profile` picks the profile of a torch device: the CPU gets
``HOST_CPU``, an H100 the H100 profile, and any other card raises, since
a prediction priced for the wrong device flips backend choices without
a sign.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-device performance envelope + dispatch-cost constants.

    Attributes:
      peak_flops: dense matmul peak (bf16 for the card's profile).
      hbm_bw: main-memory bandwidth in bytes/s.
      ici_bw: interconnect bandwidth in bytes/s.
      mem_bytes: main-memory capacity.
      dispatch_s: fixed per-step overhead (host dispatch + launch).
      op_overhead_s: per-kernel overhead inside one step — the term that
        makes multi-stage sparse pipelines lose to one dense matmul at
        short kv_len.
      pallas_native: the hand-written kernels run natively (CUDA on the
        card: the reference's name, kept so cost terms read alike); when
        False the kernel backends run their plain PyTorch versions, and
        predictions scale by ``interpret_slowdown`` so auto-selection
        never cost-picks them. The tuner's probes run on the card when
        True and on the CPU when False.
    """

    name: str
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    mem_bytes: float
    dispatch_s: float = 5e-6
    op_overhead_s: float = 1e-6
    pallas_native: bool = False
    interpret_slowdown: float = 1.0


#: NVIDIA H100 SXM (80 GB HBM3). peak_flops and hbm_bw are the data-sheet
#: bf16 dense and HBM3 peaks every kernel bound in PERF.md divides by;
#: mem_bytes is ``torch.cuda.get_device_properties(0).total_memory`` of
#: an NVIDIA H100 80GB HBM3; ici_bw the data-sheet NVLink 4 total (18
#: links), not measured (one card has no link, and nothing reads it).
#: dispatch_s and op_overhead_s were measured by
#: ``launch/measure_profile.py`` on an NVIDIA H100 80GB HBM3 at a
#: 700.00 W power limit (1.0722e-05 s and 9.899e-07 s; a second run in
#: the same call read 1.0987e-05 s and 9.994e-07 s): one replay of a
#: one-kernel CUDA graph, synchronized, and a 1,000-kernel graph's device
#: time per node. chip_smoke.py phase 5h measures them again beside these.
H100_SXM = HardwareProfile(
    name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=900e9,
    mem_bytes=85_017_493_504, dispatch_s=1.0722e-05, op_overhead_s=9.899e-07,
    pallas_native=True, interpret_slowdown=1.0)

#: Conservative CPU host envelope (the reference's values): matmul
#: throughput and DRAM bandwidth, with the kernel backends on their plain
#: versions. Absolute numbers are order-of-magnitude — the autotuner
#: compares backends under ONE profile, so ranking needs the ratios right
#: (sparsity x kv_len vs per-op overhead), not the absolutes.
HOST_CPU = HardwareProfile(
    name="host_cpu", peak_flops=5e10, hbm_bw=2.5e10, ici_bw=1e9,
    mem_bytes=8 * 2 ** 30, dispatch_s=2e-5, op_overhead_s=2e-6,
    pallas_native=False, interpret_slowdown=500.0)

PROFILES = {p.name: p for p in (H100_SXM, HOST_CPU)}

#: ``torch.cuda.get_device_name`` -> the card's profile
CARD_PROFILES = {"NVIDIA H100 80GB HBM3": H100_SXM}


def get_profile(name: str) -> HardwareProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; "
                       f"have {sorted(PROFILES)}") from None


def detect_profile(device=None) -> HardwareProfile:
    """Profile of a torch device: ``HOST_CPU`` for the CPU, the card's
    profile for a CUDA device whose name ``CARD_PROFILES`` knows. None
    means the card when CUDA is available, else the CPU. Any other card
    raises, naming it: a GPU never falls back to the CPU's profile."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return HOST_CPU
    if device.type != "cuda":
        raise ValueError(f"no hardware profile for device {device}")
    name = torch.cuda.get_device_name(device)
    try:
        return CARD_PROFILES[name]
    except KeyError:
        raise ValueError(
            f"no hardware profile for the card {name!r}; have "
            f"{sorted(CARD_PROFILES)} (add one to "
            "repro_torch.roofline.hardware)") from None
