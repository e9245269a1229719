"""RWKV-6 "Finch": an attention-free LM with data-dependent decay.

PyTorch counterpart of ``repro.models.rwkv6``. HDP does not apply (no
QKᵀ score matrix exists), so the family runs without it and accepts
``attn=`` only for a uniform call.

Per layer: the time-mix block (token shift, a decay ``w`` from a LoRA
of the input, the WKV linear-attention recurrence over a per-head fp32
state S [hd_k, hd_v] with the bonus ``u``, a per-head group norm and a
SiLU gate) and the channel-mix block (token shift, squared-ReLU key,
sigmoid receptance). A Python loop over time takes the place of the
reference's ``lax.scan``; decode is one step of it. The cache
{"state" fp32 [L,B,H,hd,hd], "tm_x", "cm_x" [L,B,D]} is O(1) in the
sequence length and is updated in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.loops import gathered, trips
from repro_torch.models import layers as L

F32 = torch.float32
LORA_R = 64


def _heads(cfg):
    return cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim


def _tm_init(cfg, gen, dt, device) -> Dict:
    d = cfg.d_model
    h, hd = _heads(cfg)
    p = {f"mu_{n}": torch.full((d,), 0.5, dtype=dt, device=device)
         for n in ("r", "k", "v", "w", "g")}
    for n in ("r", "k", "v", "g", "o"):
        p[f"W{n}"] = L.dense_init(gen, (d, d), dt, device)
    p["w0"] = torch.full((d,), -5.0, dtype=dt, device=device)  # decay bias
    p["wA"] = L.dense_init(gen, (d, LORA_R), dt, device)
    p["wB"] = L.dense_init(gen, (LORA_R, d), dt, device, scale=0.1)
    p["u"] = torch.zeros((h, hd), dtype=dt, device=device)      # bonus
    p["gn_w"] = torch.ones((h, hd), dtype=dt, device=device)
    p["gn_b"] = torch.zeros((h, hd), dtype=dt, device=device)
    return p


def _cm_init(cfg, gen, dt, device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
            "mu_r": torch.full((d,), 0.5, dtype=dt, device=device),
            "Wk": L.dense_init(gen, (d, f), dt, device),
            "Wv": L.dense_init(gen, (f, d), dt, device),
            "Wr": L.dense_init(gen, (d, d), dt, device)}


def _layer_init(cfg, gen, dt, device) -> Dict:
    return {"tm": _tm_init(cfg, gen, dt, device),
            "cm": _cm_init(cfg, gen, dt, device),
            "ln1": L.norm_init(cfg, dt, device),
            "ln2": L.norm_init(cfg, dt, device)}


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random weights in ``cfg.dtype`` on ``device`` from ``seed``."""
    device = L.resolve_device(device)
    gen = L.make_generator(seed, device)
    dt = L.torch_dtype(cfg.dtype)
    emb = L.embed_init(cfg, gen, dt, device)
    layers = L.stacked(cfg.n_layers, lambda: _layer_init(cfg, gen, dt,
                                                         device))
    return {"embed": emb, "layers": layers,
            "final_norm": L.norm_init(cfg, dt, device)}


def param_specs(cfg) -> Dict:
    """Logical axes of every leaf of ``init_params``' tree; the layer
    stack's leaves lead with ``"layers"``."""
    tm = {f"mu_{n}": ("embed",) for n in ("r", "k", "v", "w", "g")}
    tm.update({f"W{n}": ("embed", "heads") for n in ("r", "k", "v", "g")})
    tm.update(Wo=("heads", "embed"), w0=("embed",), wA=("embed", None),
              wB=(None, "embed"), u=("heads", "head_dim"),
              gn_w=("heads", "head_dim"), gn_b=("heads", "head_dim"))
    cm = {"mu_k": ("embed",), "mu_r": ("embed",), "Wk": ("embed", "mlp"),
          "Wv": ("mlp", "embed"), "Wr": ("embed", "embed")}
    layer = {"tm": tm, "cm": cm, "ln1": L.norm_specs(cfg),
             "ln2": L.norm_specs(cfg)}
    return {"embed": L.embed_specs(cfg),
            "layers": L.stack_specs(layer, "layers"),
            "final_norm": L.norm_specs(cfg)}


def _shift(x, x_prev):
    """Token shift: [B,S,D] -> the previous token's features; x_prev [B,D]."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, s0):
    """WKV-6: r, k, v, w [B,T,H,hd]; state S [B,H,hd_k,hd_v].

    y_t = (S_t + (u*k_t) outer v_t)^T r_t;  S_{t+1} = diag(w_t) S_t + k_t (x) v_t
    Returns (y [B,T,H,hd_v], the final state)."""
    S = s0
    ys = []
    for t in trips(r.shape[1], carry=True):    # a trace: four steps
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]        # outer product
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., None] * S + kv
    return gathered(ys, r.shape[1], 1), S


def _time_mix(cfg, p, x, x_prev, state):
    """Returns (out [B,S,D], new_x_prev [B,D], new_state [B,H,hd,hd])."""
    B, S, D = x.shape
    h, hd = _heads(cfg)
    xs = _shift(x, x_prev)

    def mix(name):
        mu = p[f"mu_{name}"]
        return x * mu + xs * (1.0 - mu)

    r = (mix("r") @ p["Wr"]).reshape(B, S, h, hd)
    k = (mix("k") @ p["Wk"]).reshape(B, S, h, hd)
    v = (mix("v") @ p["Wv"]).reshape(B, S, h, hd)
    g = F.silu(mix("g") @ p["Wg"])
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x_w))), rounded
    # to the model dtype before the fp32 scan, as the reference rounds it
    w_raw = p["w0"] + torch.tanh(mix("w") @ p["wA"]) @ p["wB"]
    w = torch.exp(-torch.exp(w_raw.float())).to(x.dtype)
    w = w.reshape(B, S, h, hd)
    y, new_state = _wkv_scan(r.float(), k.float(), v.float(), w.float(),
                             p["u"].float(), state.float())
    y = L.group_norm_heads(y.to(x.dtype), p["gn_w"], p["gn_b"])
    y = (y.reshape(B, S, D) * g) @ p["Wo"]
    return y, x[:, -1], new_state.to(state.dtype)


def _channel_mix(p, x, x_prev):
    xs = _shift(x, x_prev)
    xk = x * p["mu_k"] + xs * (1.0 - p["mu_k"])
    xr = x * p["mu_r"] + xs * (1.0 - p["mu_r"])
    k = torch.square(F.relu(xk @ p["Wk"]))
    return torch.sigmoid(xr @ p["Wr"]) * (k @ p["Wv"]), x[:, -1]


def _block_fn(cfg, lp, x, state, tm_x, cm_x):
    """One layer from its recurrent state: (x', state', tm_x', cm_x')."""
    hx = L.apply_norm(cfg, lp["ln1"], x)
    a, tm_x, state = _time_mix(cfg, lp["tm"], hx, tm_x, state)
    x = x + a
    hx = L.apply_norm(cfg, lp["ln2"], x)
    m, cm_x = _channel_mix(lp["cm"], hx, cm_x)
    return x + m, state, tm_x, cm_x


def _block(cfg, lp, x, lc):
    """One layer; its cache view lc {"state","tm_x","cm_x"} is updated in
    place."""
    x, state, tm_x, cm_x = _block_fn(cfg, lp, x, lc["state"], lc["tm_x"],
                                     lc["cm_x"])
    lc["state"].copy_(state)
    lc["tm_x"].copy_(tm_x)
    lc["cm_x"].copy_(cm_x)
    return x


def _stack(cfg, params, x, cache):
    for li in range(cfg.n_layers):
        x = _block(cfg, L.tree_index(params["layers"], li), x,
                   L.tree_index(cache, li))
    return x


def _train_stack(cfg, params, x):
    """Every layer from a zero state (no cache, nothing written in place:
    autograd runs through it), rematerialized when ``cfg.remat`` is set."""
    h, hd = _heads(cfg)
    B, D = x.shape[0], cfg.d_model

    def layer(x, li):
        state = torch.zeros((B, h, hd, hd), dtype=F32, device=x.device)
        shift = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        return _block_fn(cfg, L.tree_index(params["layers"], li), x, state,
                         shift, shift)[0]

    for li in range(cfg.n_layers):
        x = L.maybe_remat(cfg, True, layer, x, li)
    return x


def init_cache(cfg, batch: int, max_len: int = 0, dtype=None,
               device=None) -> Dict:
    """The recurrent cache, O(1) in the sequence length (``max_len`` is
    accepted for a uniform call): the fp32 WKV state and the last token's
    features of each mix block in the model dtype."""
    h, hd = _heads(cfg)
    dt = L.torch_dtype(dtype or cfg.dtype)
    return {
        "state": torch.zeros((cfg.n_layers, batch, h, hd, hd), dtype=F32,
                             device=device),
        "tm_x": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dt,
                            device=device),
        "cm_x": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dt,
                            device=device),
    }


def cache_specs(cfg) -> Dict:
    return {"state": ("layers", "batch", "heads", None, None),
            "tm_x": ("layers", "batch", "embed_act"),
            "cm_x": ("layers", "batch", "embed_act")}


def apply_train(cfg, params, batch, *, collect_stats: bool = False):
    """Full-sequence forward for training: (logits [B,S,V] fp32,
    {"aux_loss": a 0-d fp32 zero, "hdp": None})."""
    del collect_stats
    x = L.embed_tokens(params["embed"], batch["tokens"])
    x = _train_stack(cfg, params, x)
    x = L.apply_norm(cfg, params["final_norm"], x)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return (L.lm_logits_sharded(params["embed"], x),
            {"aux_loss": aux, "hdp": None})


def apply_prefill(cfg, params, batch, cache, *, collect_stats: bool = False,
                  attn=None):
    """Run the prompt from ``cache``'s state (a fresh zero cache when
    None), updating it in place. Returns (last-position logits [B,1,V]
    fp32, cache, None); recurrent layers have no attention, so ``attn``
    is accepted and ignored."""
    del attn, collect_stats
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], dtype=x.dtype,
                           device=x.device)
    x = _stack(cfg, params, x, cache)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return L.lm_logits_sharded(params["embed"], x), cache, None


def apply_decode(cfg, params, token, cache, pos, *,
                 collect_stats: bool = False, attn=None):
    """One recurrent step per row of token [B,S]; ``pos`` is unused (the
    state carries the position). Returns (logits [B,S,V] fp32, cache,
    None)."""
    del pos, attn, collect_stats
    x = L.embed_tokens(params["embed"], token)
    x = _stack(cfg, params, x, cache)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(params["embed"], x), cache, None


def param_count(cfg) -> int:
    d, f = cfg.d_model, cfg.d_ff
    tm = 5 * d + 5 * d * d + d + d * LORA_R + LORA_R * d + 3 * d
    cm = 2 * d + d * f + f * d + d * d
    per_layer = tm + cm + 4 * d
    return cfg.n_layers * per_layer + cfg.vocab_size * d * 2 + d
