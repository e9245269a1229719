"""Family dispatch: one API over the architectures the port serves.

  init_params(cfg, seed, device)  -> params dict
  init_cache(cfg, B, max_len)     -> dense request cache
  apply_prefill / apply_decode    -> serving steps

The dense, moe and vlm families are the transformer; any other family
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from repro_torch.models import transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer}

#: ROADMAP.md item that ports each family not served yet
_PENDING = {
    "rwkv6": "section 1, item 10 (remaining families)",
    "zamba2": "section 1, item 10 (remaining families)",
    "whisper": "section 1, item 10 (remaining families)",
}


def module_for(cfg):
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        item = _PENDING.get(cfg.family, "section 1")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md {item})")
    if cfg.pos_emb != "rope":
        # the sinusoidal table is whisper's, which comes with its family
        raise NotImplementedError(
            f"{cfg.name}: pos_emb {cfg.pos_emb!r} is not ported yet "
            "(ROADMAP.md section 1, item 10 (remaining families))")
    return mod


def init_params(cfg, seed: int = 0, device="cuda"):
    return module_for(cfg).init_params(cfg, seed, device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    return module_for(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                      device=device)


def apply_prefill(cfg, params, batch, cache, **kw):
    return module_for(cfg).apply_prefill(cfg, params, batch, cache, **kw)


def apply_decode(cfg, params, token, cache, pos, **kw):
    return module_for(cfg).apply_decode(cfg, params, token, cache, pos, **kw)


def param_count(cfg, active_only: bool = False) -> int:
    m = module_for(cfg)
    if active_only:
        return m.active_param_count(cfg)
    return m.param_count(cfg)
