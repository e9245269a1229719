"""Zamba2 hybrid: a Mamba2 backbone and ONE shared attention block (with
per-invocation LoRA) applied every ``attn_every`` layers on
concat(hidden, original embedding) [arXiv:2411.15242].

PyTorch counterpart of ``repro.models.zamba2``, with the same parameter
tree (the Mamba2 layers grouped [g, attn_every, ...] plus a tail, the
shared block's LoRA stacked over the g groups) and the same cache tree
{"mamba" [g, a, ...], "attn" {"k","v"} [g,B,S,N,hd], "tail" [t, ...]}.
HDP applies to the shared attention block only; it runs at width
2·d_model through ``attn_apply``, so with ``cache=None`` (the aligned
prefill) it resolves to the full-sequence kernels. Caches are updated
in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.attention.stats import stack_stats
from repro_torch.models import layers as L
from repro_torch.models import attention as A
from repro_torch.models import mamba2
from repro_torch.models.attention import attn_apply, attn_init

F32 = torch.float32
LORA_R = 16


def _n_groups(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def _n_tail(cfg) -> int:
    return cfg.n_layers % cfg.attn_every


def _shared_cfg(cfg):
    """The shared block runs at width 2*d_model (concat input)."""
    return cfg.replace(d_model=2 * cfg.d_model, sliding_window=0,
                       qkv_bias=False, qk_norm=False, n_experts=0)


def _shared_init(cfg, gen, dt, device) -> Dict:
    d2, d, f = 2 * cfg.d_model, cfg.d_model, cfg.d_ff
    g = _n_groups(cfg)
    h, hd = cfg.n_heads, cfg.hd
    return {
        "attn": attn_init(_shared_cfg(cfg), gen, dt, device),
        "ln1": {"w": torch.ones((d2,), dtype=dt, device=device)},
        "ln2": {"w": torch.ones((d2,), dtype=dt, device=device)},
        "mlp": {"w_gate": L.dense_init(gen, (d2, f), dt, device),
                "w_up": L.dense_init(gen, (d2, f), dt, device),
                "w_down": L.dense_init(gen, (f, d2), dt, device)},
        "proj_out": L.dense_init(gen, (d2, d), dt, device),
        # per-invocation LoRA deltas on wq/wk/wv (stacked over groups)
        "lora_A": L.dense_init(gen, (g, 3, d2, LORA_R), dt, device,
                               in_axis=2),
        "lora_B": torch.zeros((g, 3, LORA_R, h * hd), dtype=dt,
                              device=device),
    }


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random weights in ``cfg.dtype`` on ``device`` from ``seed``."""
    device = L.resolve_device(device)
    gen = L.make_generator(seed, device)
    dt = L.torch_dtype(cfg.dtype)

    def one_mamba():
        return {"m": mamba2.layer_init(cfg, gen, dt, device),
                "ln": L.norm_init(cfg, dt, device)}

    params = {"embed": L.embed_init(cfg, gen, dt, device),
              "grouped": L.stacked(_n_groups(cfg), lambda: L.stacked(
                  cfg.attn_every, one_mamba))}
    if _n_tail(cfg):
        params["tail"] = L.stacked(_n_tail(cfg), one_mamba)
    params["shared"] = _shared_init(cfg, gen, dt, device)
    params["final_norm"] = L.norm_init(cfg, dt, device)
    return params


def param_specs(cfg) -> Dict:
    """Logical axes of every leaf of ``init_params``' tree: the grouped
    Mamba2 layers lead with ``("groups", "layers")``, the tail with
    ``"layers"``; the shared block's LoRA stacks with ``"groups"``."""
    one = {"m": mamba2.param_specs(cfg), "ln": L.norm_specs(cfg)}
    specs = {"embed": L.embed_specs(cfg),
             "grouped": L.stack_specs(one, "groups", "layers")}
    if _n_tail(cfg):
        specs["tail"] = L.stack_specs(one, "layers")
    specs["shared"] = {
        "attn": A.param_specs(_shared_cfg(cfg)),
        "ln1": {"w": ("embed",)}, "ln2": {"w": ("embed",)},
        "mlp": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")},
        "proj_out": ("embed", "embed"),
        "lora_A": ("groups", None, "embed", None),
        "lora_B": ("groups", None, None, "heads"),
    }
    specs["final_norm"] = L.norm_specs(cfg)
    return specs


def _mamba_stack(cfg, layers, x, cache, train: bool = False):
    """The Mamba2 layers of one group (or the tail), each a residual
    around its norm; ``cache`` (stacked views, or None) is written in
    place. A training call rematerializes each layer when ``cfg.remat``
    is set."""
    def layer(x, li):
        lp = L.tree_index(layers, li)
        lc = None if cache is None else L.tree_index(cache, li)
        y, nc = mamba2.layer_apply(cfg, lp["m"], L.apply_norm(cfg, lp["ln"],
                                                              x), lc)
        if lc is not None:
            lc["S"].copy_(nc["S"])
            lc["conv"].copy_(nc["conv"])
        return x + y

    for li in range(layers["m"]["A_log"].shape[0]):
        x = L.maybe_remat(cfg, train, layer, x, li)
    return x


def _apply_shared(cfg, p, h, emb0, lora_a, lora_b, *, mode, positions,
                  cache, collect_stats, attn=None):
    """One invocation of the shared block; returns (h', stats)."""
    x = torch.cat([h, emb0], dim=-1)
    hln = L.rms_norm(x, p["ln1"]["w"])
    # LoRA-specialized qkv for this invocation
    d2 = 2 * cfg.d_model
    attn_p = dict(p["attn"])
    for i, w in enumerate(("wq", "wk", "wv")):
        delta = (lora_a[i] @ lora_b[i]).reshape(d2, *attn_p[w].shape[1:])
        attn_p[w] = attn_p[w] + delta
    a, _, stats = attn_apply(_shared_cfg(cfg), attn_p, hln, mode=mode,
                             positions=positions, cache=cache,
                             collect_stats=collect_stats, attn=attn)
    x = x + a
    hln = L.rms_norm(x, p["ln2"]["w"])
    m = F.silu(hln @ p["mlp"]["w_gate"]) * (hln @ p["mlp"]["w_up"])
    x = x + m @ p["mlp"]["w_down"]
    return h + x @ p["proj_out"], stats


def _run(cfg, params, tokens, *, mode, positions, cache, collect_stats,
         attn=None):
    x = L.embed_tokens(params["embed"], tokens)
    emb0 = x
    sh = params["shared"]
    train = mode == "train"

    def group(x, gi):
        mc = None if cache is None else L.tree_index(cache["mamba"], gi)
        x = _mamba_stack(cfg, L.tree_index(params["grouped"], gi), x, mc,
                         train)
        ac = None if cache is None else L.tree_index(cache["attn"], gi)
        return _apply_shared(cfg, sh, x, emb0, sh["lora_A"][gi],
                             sh["lora_B"][gi], mode=mode,
                             positions=positions, cache=ac,
                             collect_stats=collect_stats, attn=attn)

    stats = []
    for gi in range(_n_groups(cfg)):
        # a training call also rematerializes the whole group, as the
        # reference does (its backward would otherwise keep every group's
        # intermediates)
        x, st = L.maybe_remat(cfg, train, group, x, gi)
        stats.append(st)
    if _n_tail(cfg):
        x = _mamba_stack(cfg, params["tail"], x,
                         None if cache is None else cache["tail"], train)
    return x, stack_stats(stats) if collect_stats else None


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """{"mamba": {"S" [g,a,B,H,P,N] fp32, "conv" [g,a,B,W-1,di]},
    "attn": {"k","v"} [g,B,max_len,N,hd], "tail": the tail's Mamba2
    state [t, ...]} in ``dtype`` (default the config's)."""
    g, a, t = _n_groups(cfg), cfg.attn_every, _n_tail(cfg)
    dt = L.torch_dtype(dtype or cfg.dtype)
    one_m = mamba2.init_cache(cfg, batch, dt, device)
    kv = (g, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {
        "mamba": L.tree_map(lambda x: x.new_zeros((g, a) + x.shape), one_m),
        "attn": {"k": torch.zeros(kv, dtype=dt, device=device),
                 "v": torch.zeros(kv, dtype=dt, device=device)},
    }
    if t:
        cache["tail"] = L.tree_map(lambda x: x.new_zeros((t,) + x.shape),
                                   one_m)
    return cache


def cache_specs(cfg) -> Dict:
    mspec = mamba2.cache_specs()
    ax = ("groups", "batch", "kv_seq", "kv_heads", "head_dim")
    out = {"mamba": {k: ("groups", "layers") + v for k, v in mspec.items()},
           "attn": {"k": ax, "v": ax}}
    if _n_tail(cfg):
        out["tail"] = {k: ("layers",) + v for k, v in mspec.items()}
    return out


def apply_train(cfg, params, batch, *, collect_stats: bool = False):
    """Full-sequence forward for training: (logits [B,S,V] fp32,
    {"aux_loss": a 0-d fp32 zero, "hdp": the shared block's stats})."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, stats = _run(cfg, params, tokens, mode="train", positions=positions,
                    cache=None, collect_stats=collect_stats)
    x = L.apply_norm(cfg, params["final_norm"], x)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return (L.lm_logits_sharded(params["embed"], x),
            {"aux_loss": aux, "hdp": stats})


def apply_prefill(cfg, params, batch, cache, *, collect_stats: bool = False,
                  attn=None):
    """Run the prompt. With a ``cache`` (serving: exact length, from the
    state it holds) every leaf is filled in place; with ``cache=None``
    the shared block is an aligned self-attention prefill, which the
    full-sequence kernels serve. Returns (last-position logits [B,1,V]
    fp32, cache, stats stacked over the shared block's invocations)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, stats = _run(cfg, params, tokens, mode="prefill", positions=positions,
                    cache=cache, collect_stats=collect_stats, attn=attn)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return L.lm_logits_sharded(params["embed"], x), cache, stats


def apply_decode(cfg, params, token, cache, pos, *,
                 collect_stats: bool = False, attn=None):
    """One decode step: token [B,S]; pos a scalar or [B,S] per-slot
    positions (the shared block's dense slot cache). Returns (logits
    [B,S,V] fp32, cache, stats)."""
    positions = pos[None] if pos.dim() == 0 else pos
    x, stats = _run(cfg, params, token, mode="decode", positions=positions,
                    cache=cache, collect_stats=collect_stats, attn=attn)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(params["embed"], x), cache, stats


def attn_layers(cfg) -> int:
    """Attention invocations per forward (the stats' layer dim)."""
    return _n_groups(cfg)


def param_count(cfg) -> int:
    d, d2, f = cfg.d_model, 2 * cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.hd
    g = _n_groups(cfg)
    mamba = cfg.n_layers * (mamba2.param_count(cfg) + d)
    shared = (d2 * h * hd + 2 * d2 * cfg.n_kv_heads * hd + h * hd * d2
              + 2 * d2 + 3 * d2 * f // 1 + d2 * d
              + g * 3 * (d2 * LORA_R + LORA_R * h * hd))
    return mamba + shared + cfg.vocab_size * d * 2 + d
