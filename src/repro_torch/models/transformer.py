"""Decoder-only transformer LM, dense family (qwen2-style GQA).

PyTorch counterpart of ``repro.models.transformer`` for ``family="dense"``.
Parameters are a plain dict laid out exactly like the reference's tree:
every leaf under ``"layers"`` carries a leading L axis, so weights move
between the packages by copy alone (``repro_torch.convert``). A Python
loop over layers takes the place of the reference's ``lax.scan``; caches
are updated in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.attention.stats import stack_stats
from repro_torch.models import layers as L
from repro_torch.models.attention import attn_apply, attn_init


def _layer_init(cfg, gen, dtype, device) -> Dict:
    return {"attn": attn_init(cfg, gen, dtype, device),
            "ln1": L.norm_init(cfg, dtype, device),
            "ln2": L.norm_init(cfg, dtype, device),
            "ffn": L.mlp_init(cfg, gen, dtype, device)}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random weights in ``cfg.dtype`` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed`` (on the card for CUDA)."""
    device = L.resolve_device(device)
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    dtype = L.torch_dtype(cfg.dtype)
    emb = L.embed_init(cfg, gen, dtype, device)
    # each layer is drawn and copied into its row of the stacked [L, ...]
    # leaves at once, so the weights are never held twice
    layers = None
    for li in range(cfg.n_layers):
        one = _layer_init(cfg, gen, dtype, device)
        if layers is None:
            layers = _map(lambda t: t.new_empty((cfg.n_layers, *t.shape)),
                          one)
        _map2(lambda dst, src: dst[li].copy_(src), layers, one)
    return {"embed": emb, "layers": layers,
            "final_norm": L.norm_init(cfg, dtype, device)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _map2(fn, a[k], b[k])
    else:
        fn(a, b)


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Dense request cache {"k","v"} [L,B,max_len,N,hd]."""
    dt = L.torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _stack(cfg, params, x, *, mode, positions, cache, collect_stats,
           page_table=None, write_floor=None, draft=None, attn=None):
    """Loop over layers; each layer's cache view is updated in place.
    Without a cache every layer is an aligned self-attention prefill.
    Returns (x, stats) with stats leaves stacked over layers."""
    stats = []
    for li in range(cfg.n_layers):
        lp = _index(params["layers"], li)
        lc = None if cache is None else {k: v[li] for k, v in cache.items()}
        h = L.rms_norm(x, lp["ln1"]["w"])
        a, _, st = attn_apply(cfg, lp["attn"], h, mode=mode,
                              positions=positions, cache=lc,
                              collect_stats=collect_stats,
                              page_table=page_table,
                              write_floor=write_floor, draft=draft,
                              attn=attn)
        x = x + a
        h = L.rms_norm(x, lp["ln2"]["w"])
        x = x + L.mlp_apply(cfg, lp["ffn"], h)
        stats.append(st)
    return x, (stack_stats(stats) if collect_stats else None)


def apply_prefill(cfg, params, batch, cache, *, collect_stats: bool = False,
                  pos_offset: int = 0, attn=None):
    """Run the prompt and return (last-position logits [B,1,V] fp32,
    cache, stats). With a request ``cache`` it is filled in place (K/V
    snapped to the pool format, see ``attn_apply``); with ``cache=None``
    the prompt is an aligned self-attention prefill, which the
    full-sequence kernels serve. ``pos_offset`` is the absolute position of ``tokens[:, 0]``:
    nonzero for chunked prefill, where each chunk appends to the cache
    behind the previous ones and attends to all of them. ``attn``
    selects the attention backend (an ``AttnSpec``)."""
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    positions = pos_offset + torch.arange(tokens.shape[1],
                                          device=tokens.device)
    x, stats = _stack(cfg, params, x, mode="prefill", positions=positions,
                      cache=cache, collect_stats=collect_stats, attn=attn)
    x = L.rms_norm(x[:, -1:], params["final_norm"]["w"])
    return L.lm_logits(params["embed"], x), cache, stats


def apply_decode(cfg, params, token, cache, pos, *,
                 collect_stats: bool = False, page_table=None,
                 write_floor=None, draft=None, attn=None):
    """One decode step. token [B,S]; pos [B,S] int positions (S > 1: a
    multi-query verify call over consecutive positions, each row scouted
    as its own single step would be); ``cache`` the paged pool dict with
    [L,...] leaves and page_table [B,nP] int32 (``write_floor`` [B]
    fencing shared prefix pages), or the dense slot cache {"k","v"}
    [L,B,Smax,N,hd] without a table (updated in place either way).
    ``draft`` (a DraftProfile) marks a speculative draft step. Returns
    (logits [B,S,V] fp32, cache, stats)."""
    x = L.embed_tokens(params["embed"], token)
    x, stats = _stack(cfg, params, x, mode="decode", positions=pos,
                      cache=cache, collect_stats=collect_stats,
                      page_table=page_table, write_floor=write_floor,
                      draft=draft, attn=attn)
    x = L.rms_norm(x, params["final_norm"]["w"])
    return L.lm_logits(params["embed"], x), cache, stats


def param_count(cfg) -> int:
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    ffn = 3 * d * f
    per_layer = attn + ffn + 2 * d
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return cfg.n_layers * per_layer + emb + d
