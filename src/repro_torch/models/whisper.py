"""Whisper-large-v3 backbone (encoder-decoder, audio).

PyTorch counterpart of ``repro.models.whisper``. The conv frontend is a
stub: precomputed frame embeddings [B, S_enc, d_model] go through a
learned linear adapter. Positions are sinusoidal in the encoder and the
decoder. HDP applies to the decoder's self- and cross-attention; the
encoder's non-causal self-attention runs as a trainable call, which
takes HDP only with ``hdp.apply_in_training`` (off by default), as in
the reference.

The decoder's sinusoid starts at ``positions[0]``, as the reference's
does: a decode step with per-slot positions [B, 1] gives every row slot
0's offset (ROADMAP.md section 3). The serving engine refuses
encoder-decoder configs as the reference's does, so whisper is served
at model level: ``apply_prefill`` encodes the frames and fills the self
and cross caches, ``apply_decode`` steps the decoder against them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.attention.stats import stack_stats
from repro_torch.models import layers as L
from repro_torch.models import attention as A
from repro_torch.models.attention import attn_apply, attn_init


def _enc_layer_init(cfg, gen, dt, device) -> Dict:
    return {"attn": attn_init(cfg, gen, dt, device),
            "ln1": L.norm_init(cfg, dt, device),
            "ln2": L.norm_init(cfg, dt, device),
            "mlp": L.mlp_init(cfg, gen, dt, device)}


def _dec_layer_init(cfg, gen, dt, device) -> Dict:
    return {"self": attn_init(cfg, gen, dt, device),
            "cross": attn_init(cfg, gen, dt, device),
            "mlp": L.mlp_init(cfg, gen, dt, device),
            "ln1": L.norm_init(cfg, dt, device),
            "ln2": L.norm_init(cfg, dt, device),
            "ln3": L.norm_init(cfg, dt, device)}


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random weights in ``cfg.dtype`` on ``device`` from ``seed``."""
    device = L.resolve_device(device)
    gen = L.make_generator(seed, device)
    dt = L.torch_dtype(cfg.dtype)
    return {
        "embed": L.embed_init(cfg, gen, dt, device),
        "frontend": {"w": L.dense_init(gen, (cfg.d_model, cfg.d_model), dt,
                                       device)},
        "enc": L.stacked(cfg.encoder_layers,
                         lambda: _enc_layer_init(cfg, gen, dt, device)),
        "dec": L.stacked(cfg.decoder_layers,
                         lambda: _dec_layer_init(cfg, gen, dt, device)),
        "ln_enc": L.norm_init(cfg, dt, device),
        "ln_dec": L.norm_init(cfg, dt, device),
    }


def param_specs(cfg) -> Dict:
    """Logical axes of every leaf of ``init_params``' tree; the encoder's
    and decoder's layer stacks lead with ``"layers"``."""
    enc = {"attn": A.param_specs(cfg), "ln1": L.norm_specs(cfg),
           "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    dec = {"self": A.param_specs(cfg), "cross": A.param_specs(cfg),
           "mlp": L.mlp_specs(cfg), "ln1": L.norm_specs(cfg),
           "ln2": L.norm_specs(cfg), "ln3": L.norm_specs(cfg)}
    return {"embed": L.embed_specs(cfg), "frontend": {"w": ("embed", "embed")},
            "enc": L.stack_specs(enc, "layers"),
            "dec": L.stack_specs(dec, "layers"),
            "ln_enc": L.norm_specs(cfg), "ln_dec": L.norm_specs(cfg)}


def encode(cfg, params, frames, *, collect_stats: bool = False,
           train: bool = False):
    """frames [B,S,D] (stub embeddings) -> (encoder states [B,S,D], the
    self-attention stats stacked over layers or None). A training call
    rematerializes each layer when ``cfg.remat`` is set."""
    x = frames @ params["frontend"]["w"]
    x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model,
                             device=x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, li):
        lp = L.tree_index(params["enc"], li)
        h = L.apply_norm(cfg, lp["ln1"], x)
        a, _, st = attn_apply(cfg, lp["attn"], h, mode="train",
                              positions=positions, causal=False,
                              collect_stats=collect_stats)
        x = x + a
        h = L.apply_norm(cfg, lp["ln2"], x)
        return x + L.mlp_apply(cfg, lp["mlp"], h), st

    stats = []
    for li in range(cfg.encoder_layers):
        x, st = L.maybe_remat(cfg, train, layer, x, li)
        stats.append(st)
    return (L.apply_norm(cfg, params["ln_enc"], x),
            stack_stats(stats) if collect_stats else None)


def _decoder(cfg, params, tokens, enc_out, cache, positions, mode,
             collect_stats=False, attn=None):
    """The decoder over its self and cross caches (updated in place; the
    cross cache only at prefill: at decode it is read as it is). Mode
    "train" runs without caches, each layer rematerialized when
    ``cfg.remat`` is set."""
    x = L.embed_tokens(params["embed"], tokens)
    x = x + L.sinusoidal_pos(tokens.shape[1], cfg.d_model,
                             offset=positions[0]).to(x.dtype)

    def layer(x, li):
        lp = L.tree_index(params["dec"], li)
        lc = None if cache is None else L.tree_index(cache, li)
        h = L.apply_norm(cfg, lp["ln1"], x)
        a, _, st = attn_apply(cfg, lp["self"], h, mode=mode,
                              positions=positions,
                              cache=None if lc is None else lc["self"],
                              collect_stats=collect_stats, attn=attn)
        x = x + a
        h = L.apply_norm(cfg, lp["ln2"], x)
        if mode == "decode":
            c, _, _ = attn_apply(cfg, lp["cross"], h, mode=mode,
                                 positions=positions, cache=lc["cross"],
                                 static_cache=True, attn=attn)
        else:
            c, _, _ = attn_apply(cfg, lp["cross"], h, mode=mode,
                                 positions=positions,
                                 cache=None if lc is None else lc["cross"],
                                 enc_out=enc_out, attn=attn)
        x = x + c
        h = L.apply_norm(cfg, lp["ln3"], x)
        return x + L.mlp_apply(cfg, lp["mlp"], h), st

    stats = []
    for li in range(cfg.decoder_layers):
        x, st = L.maybe_remat(cfg, mode == "train", layer, x, li)
        stats.append(st)
    return (L.apply_norm(cfg, params["ln_dec"], x),
            stack_stats(stats) if collect_stats else None)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
               enc_len: int = 0) -> Dict:
    """{"self", "cross"}: {"k","v"} [L_dec, B, max_len | enc_len, N, hd];
    ``enc_len`` defaults to the config's ``max_source_positions`` (1500)."""
    dt = L.torch_dtype(dtype or cfg.dtype)
    n, hd, dl = cfg.n_kv_heads, cfg.hd, cfg.decoder_layers
    enc_len = enc_len or cfg.max_source_positions or 1500

    def kv(s):
        return {name: torch.zeros((dl, batch, s, n, hd), dtype=dt,
                                  device=device) for name in ("k", "v")}

    return {"self": kv(max_len), "cross": kv(enc_len)}


def cache_specs(cfg) -> Dict:
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"self": {"k": ax, "v": ax}, "cross": {"k": ax, "v": ax}}


def apply_train(cfg, params, batch, *, collect_stats: bool = False):
    """Encode ``batch["frames"]`` and run the decoder over
    ``batch["tokens"]`` without caches: (logits [B,S,V] fp32,
    {"aux_loss": a 0-d fp32 zero, "hdp": decoder self-attention
    stats})."""
    enc_out, _ = encode(cfg, params, batch["frames"],
                        collect_stats=collect_stats, train=True)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, stats = _decoder(cfg, params, tokens, enc_out, None, positions,
                        "train", collect_stats)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (L.lm_logits_sharded(params["embed"], x),
            {"aux_loss": aux, "hdp": stats})


def apply_prefill(cfg, params, batch, cache, *, collect_stats: bool = False,
                  attn=None):
    """Encode ``batch["frames"]``, run the decoder over the prompt
    ``batch["tokens"]`` and fill both caches (in place). Returns
    (last-position logits [B,1,V] fp32, cache, decoder self-attention
    stats)."""
    enc_out, _ = encode(cfg, params, batch["frames"],
                        collect_stats=collect_stats)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, stats = _decoder(cfg, params, tokens, enc_out, cache, positions,
                        "prefill", collect_stats, attn=attn)
    return L.lm_logits_sharded(params["embed"], x[:, -1:]), cache, stats


def apply_decode(cfg, params, token, cache, pos, *,
                 collect_stats: bool = False, attn=None):
    """One decoder step against the caches: token [B,S]; pos a scalar or
    [B,S] per-slot positions. Returns (logits [B,S,V] fp32, cache,
    stats)."""
    positions = pos[None] if pos.dim() == 0 else pos
    x, stats = _decoder(cfg, params, token, None, cache, positions,
                        "decode", collect_stats, attn=attn)
    return L.lm_logits(params["embed"], x), cache, stats


def param_count(cfg) -> int:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d + 3 * (cfg.n_heads * hd + cfg.n_kv_heads * hd)
    mlp = 2 * d * f + f + d
    enc = cfg.encoder_layers * (attn + mlp + 4 * d)
    dec = cfg.decoder_layers * (2 * attn + mlp + 6 * d)
    return enc + dec + cfg.vocab_size * d + d * d + 2 * d
