"""Family dispatch: one API over the architectures the port serves.

  init_params(cfg, seed, device)  -> params dict
  init_cache(cfg, B, max_len)     -> dense request cache
  apply_prefill / apply_decode    -> serving steps

Only the dense transformer family is ported; any other family raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from repro_torch.models import transformer

_FAMILIES = {"dense": transformer}

#: ROADMAP.md item that ports each family not served yet
_PENDING = {
    "moe": "section 1, item 4 (moe/vlm model stack)",
    "vlm": "section 1, item 4 (moe/vlm model stack)",
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
    if (cfg.norm, cfg.act, cfg.pos_emb, cfg.qk_norm) \
            != ("rmsnorm", "silu_glu", "rope", False):
        raise NotImplementedError(
            f"{cfg.name}: only rmsnorm + silu_glu + rope dense models without "
            "qk-norm are ported (ROADMAP.md section 1, item 4)")
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


def param_count(cfg) -> int:
    return module_for(cfg).param_count(cfg)
