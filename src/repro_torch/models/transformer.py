"""Decoder-only transformer LM (dense, moe and vlm families).

PyTorch counterpart of ``repro.models.transformer``: qwen2, granite,
h2o-danube, nemotron-4, olmoe, llama4-scout and chameleon — GQA and
MHA, RoPE, qk-norm, QKV bias, sliding windows, the SiLU-GLU, GELU and
squared-ReLU MLPs, RMSNorm or LayerNorm, and MoE FFNs with a shared
expert (``repro_torch.models.moe``), all driven by ``ModelConfig``.
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
from repro_torch.models import moe as M
from repro_torch.models import attention as A
from repro_torch.models.attention import attn_apply, attn_init


def _layer_init(cfg, gen, dtype, device) -> Dict:
    ffn = (M.moe_init if cfg.n_experts else L.mlp_init)(cfg, gen, dtype,
                                                         device)
    return {"attn": attn_init(cfg, gen, dtype, device),
            "ln1": L.norm_init(cfg, dtype, device),
            "ln2": L.norm_init(cfg, dtype, device),
            "ffn": ffn}


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random weights in ``cfg.dtype`` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed`` (on the card for CUDA)."""
    device = L.resolve_device(device)
    gen = L.make_generator(seed, device)
    dtype = L.torch_dtype(cfg.dtype)
    emb = L.embed_init(cfg, gen, dtype, device)
    layers = L.stacked(cfg.n_layers,
                       lambda: _layer_init(cfg, gen, dtype, device))
    return {"embed": emb, "layers": layers,
            "final_norm": L.norm_init(cfg, dtype, device)}


def param_specs(cfg) -> Dict:
    """Logical axes of every leaf of ``init_params``' tree; the layer
    stack's leaves lead with ``"layers"``."""
    layer = {"attn": A.param_specs(cfg), "ln1": L.norm_specs(cfg),
             "ln2": L.norm_specs(cfg),
             "ffn": (M.param_specs if cfg.n_experts else L.mlp_specs)(cfg)}
    return {"embed": L.embed_specs(cfg),
            "layers": L.stack_specs(layer, "layers"),
            "final_norm": L.norm_specs(cfg)}


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Dense request cache {"k","v"} [L,B,max_len,N,hd]."""
    dt = L.torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_specs(cfg) -> Dict:
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


def _stack(cfg, params, x, *, mode, positions, cache, collect_stats,
           page_table=None, write_floor=None, draft=None, attn=None):
    """Loop over layers; each layer's cache view is updated in place.
    Without a cache every layer is an aligned self-attention prefill (or,
    in mode "train", a trainable call, each layer rematerialized when
    ``cfg.remat`` is set, as the reference checkpoints its scan body).
    Returns (x, stats, aux) with stats leaves stacked over layers and aux
    the MoE load-balancing loss summed over layers (None without
    experts)."""
    def layer(x, li):
        lp = L.tree_index(params["layers"], li)
        lc = None if cache is None else {k: v[li] for k, v in cache.items()}
        h = L.apply_norm(cfg, lp["ln1"], x)
        a, _, st = attn_apply(cfg, lp["attn"], h, mode=mode,
                              positions=positions, cache=lc,
                              collect_stats=collect_stats,
                              page_table=page_table,
                              write_floor=write_floor, draft=draft,
                              attn=attn)
        x = x + a
        h = L.apply_norm(cfg, lp["ln2"], x)
        la = None
        if cfg.n_experts:
            m, la = M.moe_apply(cfg, lp["ffn"], h)
        else:
            m = L.mlp_apply(cfg, lp["ffn"], h)
        return x + m, st, la

    stats, aux = [], []
    for li in range(cfg.n_layers):
        x, st, la = L.maybe_remat(cfg, mode == "train", layer, x, li)
        stats.append(st)
        if la is not None:
            aux.append(la)
    return (x, stack_stats(stats) if collect_stats else None,
            torch.stack(aux).sum() if aux else None)


def apply_train(cfg, params, batch, *, collect_stats: bool = False):
    """Full-sequence forward for training: (logits [B,S,V] fp32,
    {"aux_loss": the MoE losses summed over layers (a 0-d fp32 zero
    without experts), "hdp": stats}). Attention runs as a trainable call,
    which no kernel backend takes (none has a gradient), as in the
    reference."""
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, stats, aux = _stack(cfg, params, x, mode="train", positions=positions,
                           cache=None, collect_stats=collect_stats)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (L.lm_logits_sharded(params["embed"], x),
            {"aux_loss": aux, "hdp": stats})


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
    x, stats, _ = _stack(cfg, params, x, mode="prefill",
                         positions=positions, cache=cache,
                         collect_stats=collect_stats, attn=attn)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return L.lm_logits_sharded(params["embed"], x), cache, stats


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
    x, stats, _ = _stack(cfg, params, x, mode="decode", positions=pos,
                         cache=cache, collect_stats=collect_stats,
                         page_table=page_table, write_floor=write_floor,
                         draft=draft, attn=attn)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(params["embed"], x), cache, stats


def _count(cfg, routed: int) -> int:
    """The reference's parameter count (a layer's biases and qk-norm
    weights left out) with ``routed`` experts of each MoE layer."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    if cfg.n_experts:
        ffn = routed * 3 * d * f + d * cfg.n_experts \
            + 3 * d * f * cfg.n_shared_experts
    else:
        ffn = (3 if cfg.act == "silu_glu" else 2) * d * f
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return cfg.n_layers * (attn + ffn + 2 * d) + emb + d


def param_count(cfg) -> int:
    return _count(cfg, cfg.n_experts)


def active_param_count(cfg) -> int:
    """Parameters a token runs through: its K routed experts (with the
    router and the shared expert) in place of all of them."""
    return _count(cfg, cfg.n_experts_active)
