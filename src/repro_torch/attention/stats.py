"""One normalized stats shape for every attention backend.

PyTorch counterpart of ``repro.attention.stats``: every registered
backend returns ``AttnStats | None``, with dict-style access kept for
consumers that index stats by name (the engine's ``_record_stats``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

FIELDS = ("block_sparsity", "head_sparsity", "theta_head", "page_sparsity")


@dataclasses.dataclass
class AttnStats:
    """Diagnostics from one attention call (tensors or None).

    block_sparsity: pruned-block fraction over valid blocks (scalar, or
      [B] per slot in decode).
    head_sparsity: pruned-head fraction (same shape rule).
    theta_head: per-head importances (optional).
    page_sparsity: never-fetched page fraction (paged decode only).
    """

    block_sparsity: torch.Tensor
    head_sparsity: torch.Tensor
    theta_head: Optional[torch.Tensor] = None
    page_sparsity: Optional[torch.Tensor] = None

    def __getitem__(self, key: str):
        val = getattr(self, key)
        if val is None:
            raise KeyError(key)
        return val

    def get(self, key: str, default=None):
        try:
            return self[key]
        except (KeyError, AttributeError):
            return default

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None


def normalize_stats(raw: Any) -> Optional[AttnStats]:
    """Coerce a backend's native stats (dict / AttnStats / None) to
    AttnStats; keys other than the four fields are dropped."""
    if raw is None or isinstance(raw, AttnStats):
        return raw
    if isinstance(raw, Mapping):
        return AttnStats(
            block_sparsity=torch.as_tensor(raw["block_sparsity"]),
            head_sparsity=torch.as_tensor(raw["head_sparsity"]),
            theta_head=raw.get("theta_head"),
            page_sparsity=raw.get("page_sparsity"))
    raise TypeError(f"cannot normalize stats of type {type(raw).__name__}")


def stack_stats(per_layer) -> Optional[AttnStats]:
    """Stack the per-layer stats of a layer loop along a new leading L
    axis (what the reference's ``lax.scan`` over layers produces)."""
    if not per_layer or per_layer[0] is None:
        return None
    return AttnStats(**{
        f: (None if getattr(per_layer[0], f) is None else
            torch.stack([getattr(s, f) for s in per_layer]))
        for f in FIELDS})
