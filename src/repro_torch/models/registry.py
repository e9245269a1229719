"""Family dispatch: one API over every architecture.

  init_params(cfg, seed, device)  -> params dict
  param_specs(cfg)                -> logical axis names of every leaf
  abstract_params(cfg)            -> (meta-tensor params, param_specs)
  apply_train(cfg, p, batch)      -> (logits, {"aux_loss", "hdp"})
  init_cache(cfg, B, max_len)     -> request cache tree
  cache_specs(cfg)                -> logical axis names of every cache leaf
  apply_prefill / apply_decode    -> serving steps
  input_specs(cfg, shape)         -> ShapeDtype stand-ins of every input

The dense, moe and vlm families are the transformer; rwkv6, zamba2 and
whisper have modules of their own, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
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


def param_specs(cfg):
    """The params tree with each leaf's logical axis names (the second
    value of the reference's ``init_params``): layer-stacked leaves lead
    with ``"layers"``."""
    return module_for(cfg).param_specs(cfg)


def abstract_params(cfg):
    """(params as meta tensors, ``param_specs(cfg)``): shapes and dtypes
    at any size, with no memory allocated."""
    return init_params(cfg, device="meta"), param_specs(cfg)


def apply_train(cfg, params, batch, **kw):
    return module_for(cfg).apply_train(cfg, params, batch, **kw)


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


# ------------------------------------------------------------- input specs
@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of an input (the reference's ShapeDtypeStruct): a
    leaf of a tree, as a tensor is."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg, shape) -> Dict[str, Any]:
    """ShapeDtype stand-ins for every model input of this cell.

    train:   {"batch": {"tokens" [B,S]} (+frames for audio)}
    prefill: {"batch": {...}}
    decode:  {"token" [B,1], "pos" scalar}"""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def tok(*s):
        return ShapeDtype(tuple(s), i32)

    def act(*s):
        return ShapeDtype(tuple(s), L.torch_dtype(cfg.dtype))

    if cfg.is_encoder_decoder:
        dec_len = max(S // 8, 8)
        if shape.kind in ("train", "prefill"):
            return {"batch": {"frames": act(B, S, cfg.d_model),
                              "tokens": tok(B, dec_len)}}
        return {"token": tok(B, 1), "pos": ShapeDtype((), i32)}

    if shape.kind in ("train", "prefill"):
        return {"batch": {"tokens": tok(B, S)}}
    return {"token": tok(B, 1), "pos": ShapeDtype((), i32)}


def decode_cache_len(cfg, shape) -> int:
    """KV length the decode cell must hold (ring-buffered for SWA)."""
    if cfg.sliding_window:
        return min(shape.seq_len, max(cfg.sliding_window * 2, 16))
    return shape.seq_len
