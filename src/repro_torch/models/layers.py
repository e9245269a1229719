"""Common building blocks over plain parameter dicts.

PyTorch counterpart of ``repro.models.layers`` for the transformer
families: RMSNorm and LayerNorm, rotary embeddings, the SiLU-GLU, GELU
and squared-ReLU MLPs, token embedding and tied logits. Initialisers draw from an explicit ``torch.Generator``; the
numbers differ from ``jax.random`` for the same seed, so the tests move
weights between the packages with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype string (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the "
            "card by default; pass device='cpu' to run the plain versions")
    return dev


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               device, in_axis: int = 0, scale: float = 1.0) -> torch.Tensor:
    """Truncated normal in [-2, 2] times scale/sqrt(fan_in), with fan_in
    the product of ``shape[in_axis:-1]`` (the reference's rule)."""
    fan_in = 1
    for a in (shape[in_axis:-1] if in_axis >= 0 else shape[:-1]):
        fan_in *= a
    std = scale / (max(fan_in, 1) ** 0.5)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(torch_dtype(dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    # theta filled in on the device (not copied from the host): CUDA
    # graph capture of the decode step records it
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [S] or [..., S] (absolute)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * freqs           # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], -1).to(x.dtype)


def norm_init(cfg, dtype, device) -> Params:
    dt = torch_dtype(dtype)
    p = {"w": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
    return p


def apply_norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def mlp_init(cfg, gen, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu_glu":
        return {"w_gate": dense_init(gen, (d, f), dtype, device),
                "w_up": dense_init(gen, (d, f), dtype, device),
                "w_down": dense_init(gen, (f, d), dtype, device)}
    if cfg.act not in ("gelu", "relu2"):
        raise ValueError(f"unknown act {cfg.act}")
    p = {"w1": dense_init(gen, (d, f), dtype, device),
         "w2": dense_init(gen, (f, d), dtype, device)}
    if cfg.act == "gelu":           # whisper-style biases
        dt = torch_dtype(dtype)
        p["b1"] = torch.zeros(f, dtype=dt, device=device)
        p["b2"] = torch.zeros(d, dtype=dt, device=device)
    return p


def mlp_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu_glu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["w1"]
    if cfg.act == "gelu":
        h = F.gelu(h + p["b1"], approximate="tanh")
        return h @ p["w2"] + p["b2"]
    # relu2 (nemotron-4): squared ReLU, no bias
    return torch.square(F.relu(h)) @ p["w2"]


def embed_init(cfg, gen, dtype, device) -> Params:
    p = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                           device, scale=1.0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p.get("lm_head")
    if w is None:
        w = p["tok"].T
    return (x @ w).float()
