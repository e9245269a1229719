"""Family dispatch: one API over every architecture.

  init_params(cfg, seed, device)  -> params dict
  init_cache(cfg, B, max_len)     -> request cache tree
  cache_specs(cfg)                -> logical axis names of every cache leaf
  apply_prefill / apply_decode    -> serving steps

The dense, moe and vlm families are the transformer; rwkv6, zamba2 and
whisper have modules of their own, as in the reference.
"""
from __future__ import annotations

from repro_torch.models import rwkv6, transformer, whisper, zamba2

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "rwkv6": rwkv6,
    "zamba2": zamba2,
    "whisper": whisper,
}


def module_for(cfg):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r}") from None


def init_params(cfg, seed: int = 0, device="cuda"):
    return module_for(cfg).init_params(cfg, seed, device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
               **kw):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                      device=device, **kw)


def cache_specs(cfg):
    """The cache tree with each leaf's logical axis names (a "batch" axis
    on every leaf; "kv_seq" on the leaves indexed by position)."""
    return module_for(cfg).cache_specs(cfg)


def attn_layers(cfg) -> int:
    """Attention calls per forward: the layer dim of the HDP stats."""
    m = module_for(cfg)
    return m.attn_layers(cfg) if hasattr(m, "attn_layers") else cfg.n_layers


def apply_prefill(cfg, params, batch, cache, **kw):
    return module_for(cfg).apply_prefill(cfg, params, batch, cache, **kw)


def apply_decode(cfg, params, token, cache, pos, **kw):
    return module_for(cfg).apply_decode(cfg, params, token, cache, pos, **kw)


def param_count(cfg, active_only: bool = False) -> int:
    m = module_for(cfg)
    if active_only and hasattr(m, "active_param_count"):
        return m.active_param_count(cfg)
    return m.param_count(cfg)
