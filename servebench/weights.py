"""Random weights for a run, drawn from its seed on the device, in the
layout and type the program serves.

The leaves and their shapes are the program's own
(``registry.abstract_params``: meta tensors, nothing allocated). Each
leaf is drawn with one call over its whole layer stack: a standard
normal in the served dtype from a ``torch.Generator`` on the device,
clamped to +/-2 and scaled by 1/sqrt(fan_in), the fan-in the port's
initialiser uses (all axes but the last; an expert stack's own input
axis), except the query and key projections, whose fan-in is their input
width alone: q and k then have unit scale, as under trained weights,
where the integer scout finds integer parts (by the port's rule a
[d, heads, hd] leaf would divide by sqrt(d * heads), and without a
qk-norm no query of granite-8b reaches an integer part of 1, so the
scout sums to 0 and the head gate turns every head off). Norm weights
are 1. The same tensors go to the engine and to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

#: groups whose weight ``w`` is a norm's, and qk-norm's leaves: ones
_NORMS = ("ln1", "ln2", "final_norm")
_ONES = ("q_norm", "k_norm")
#: bias leaves: zeros
_BIASES = ("b", "bq", "bk", "bv", "b1", "b2")
#: projections drawn at unit output scale (fan-in: their input width)
_UNIT = ("wq", "wk")


def _fan_in(path, shape, stacked: bool, experts: bool) -> int:
    dims = shape[1:] if stacked else shape
    if path[-1] in _UNIT:
        return dims[0]
    if experts and path[-1] in ("w_gate", "w_up", "w_down"):
        return dims[1]
    n = 1
    for a in dims[:-1]:
        n *= a
    return n


def draw(cfg, seed: int, device) -> Dict:
    """The weights of ``cfg`` (the program's ModelConfig) from ``seed``."""
    from repro_torch.models import registry

    dev = torch.device(device)
    meta, _ = registry.abstract_params(cfg)
    gen = torch.Generator(device=dev.type)
    gen.manual_seed(int(seed) % (2 ** 63))
    experts = bool(cfg.n_experts)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[-1] in _ONES or (path[-1] == "w" and path[-2] in _NORMS):
            return torch.ones(tree.shape, dtype=tree.dtype, device=dev)
        if path[-1] in _BIASES:
            return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
        w = torch.randn(tree.shape, dtype=tree.dtype, device=dev,
                        generator=gen)
        fan = _fan_in(path, tuple(tree.shape), path[0] == "layers",
                      experts)
        return w.clamp_(-2.0, 2.0).mul_(1.0 / fan ** 0.5)

    return walk(meta, ())
