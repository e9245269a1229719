"""The traced run's profiler slice reduced to numbers: device busy time,
time by kernel group, the FUM kernels' time, and the longest idle gaps
with what the host was doing in each.

Kernel groups are those of the port's ``launch/profile_decode.py``
(copied here, so that the yardstick stays with the benchmark): the first
group whose key is a substring of the kernel's name, else "other".
"""
from __future__ import annotations

from typing import Dict, List, Tuple

GROUPS = (("fum", "fum_"), ("gemm", "nvjet"), ("gemm", "gemm"),
          ("sort", "sort"), ("reduce", "reduce_kernel"),
          ("index", "index"), ("index", "scatter"), ("index", "gather"),
          ("elementwise", "elementwise_kernel"), ("copy", "copy"))


def group_of(name: str) -> str:
    return next((g for g, key in GROUPS if key in name), "other")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(prof, wall_s: float, top: int = 10) -> Dict:
    """Seconds throughout. ``wall_s`` is the slice's length on the host
    clock (the profiler started and stopped after a synchronise)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    groups: Dict[str, float] = {}
    fum_us = 0.0
    for a, b, name in dev:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + (b - a)
        if g == "fum":
            fum_us += b - a
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    host.sort()
    named = []
    for a, b in gaps:
        inner = [h for h in host if h[0] <= a < h[1]]
        if inner:
            outer = min(inner, key=lambda h: h[0])
            deep = max(inner, key=lambda h: h[0])
            name = outer[2] if outer is deep else f"{outer[2]} > {deep[2]}"
        else:
            name = "host outside any traced operation"
        named.append([name, (b - a) / 1e6])
    return {"window_s": wall_s, "busy_s": busy_us / 1e6,
            "fum_s": fum_us / 1e6, "kernels": len(dev),
            "device_ops": [[g, s / 1e6] for g, s in
                           sorted(groups.items(), key=lambda kv: -kv[1])][:top],
            "idle_gaps": named}
