"""Common building blocks over plain parameter dicts.

PyTorch counterpart of ``repro.models.layers``: RMSNorm, LayerNorm and
RWKV's per-head group norm, rotary and sinusoidal position codes, the
SiLU-GLU, GELU and squared-ReLU MLPs, token embedding and tied logits. Initialisers draw from an explicit ``torch.Generator``; the
numbers differ from ``jax.random`` for the same seed, so the tests move
weights between the packages with ``repro_torch.convert`` instead.

The reference's ``*_init`` return ``(params, specs)``; here the spec half
of each is a function of its own (``norm_specs``, ``mlp_specs``,
``embed_specs``): the logical axis names of every leaf, the tree that
``registry.param_specs`` assembles and ``distribution.sharding`` maps
onto a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distribution.sharding import shard_activation as shd

Params = Dict[str, torch.Tensor]
#: a params tree's logical axes: the same dicts, a tuple of axis names
#: (or None) at each leaf
Specs = Dict[str, Any]

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


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i: int):
    """Row ``i`` of every leaf (a layer's view of stacked parameters or
    caches)."""
    return tree_map(lambda t: t[i], tree)


def maybe_remat(cfg, train: bool, fn, *args):
    """``fn(*args)``, rematerialized in the backward pass when the config
    asks for it on a training call (the reference's ``jax.checkpoint``
    around a scan body): only ``fn``'s inputs are kept, and its
    activations are recomputed when the gradient reaches it."""
    if cfg.remat and train:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def stacked(n: int, make):
    """``n`` trees drawn by ``make()`` stacked into [n, ...] leaves, each
    copied into its row as it is drawn, so the weights are never held
    twice (a 14 GB model is built on the card once)."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n, *t.shape)), one)
        _copy_row(out, one, i)
    return out


def _copy_row(dst, src, i: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_row(dst[k], src[k], i)
    else:
        dst[i].copy_(src)


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """The initialisers' generator, on the card for a CUDA device."""
    gen = torch.Generator(device="cuda" if device.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    return gen


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


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5):
    """Per-head group norm for RWKV: x [..., H, hd]. The means are sums
    times 1/hd, as XLA compiles the reference's division by the count."""
    dt = x.dtype
    x = x.float()
    inv = 1.0 / x.shape[-1]
    mu = x.sum(-1, keepdim=True) * inv
    var = ((x - mu) ** 2).sum(-1, keepdim=True) * inv
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


def sinusoidal_pos(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """[seq, d] fp32 sinusoid table from position ``offset`` (an int or a
    one-element tensor): sin on the even columns, cos on the odd ones.
    The cos columns take the first ``d - d // 2`` angles, as the
    reference's slice does, so an odd ``d`` (one cos column fewer than
    angles) raises ValueError there as here."""
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
        offset = offset.reshape(-1)[:1].float()
    pos = (torch.arange(seq, dtype=torch.float32, device=device)
           + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.full((), 10_000.0, device=device), dim / d)
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    cos = torch.cos(ang[:, : (d - d // 2)])
    if cos.shape[1] != d // 2:
        raise ValueError(f"Incompatible shapes for broadcasting: "
                         f"{tuple(cos.shape)} and requested shape "
                         f"({seq}, {d // 2})")
    out[:, 1::2] = cos
    return out


def norm_init(cfg, dtype, device) -> Params:
    dt = torch_dtype(dtype)
    p = {"w": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
    return p


def norm_specs(cfg) -> Specs:
    s = {"w": ("embed",)}
    if cfg.norm == "layernorm":
        s["b"] = ("embed",)
    return s


def stack_specs(specs: Specs, *axes) -> Specs:
    """``specs`` with ``axes`` put before every leaf's axes: the specs of
    a stack of layers (``("layers",)``, zamba2's ``("groups", "layers")``)."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, *axes) for k, v in specs.items()}
    return tuple(axes) + tuple(specs)


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


def mlp_specs(cfg) -> Specs:
    if cfg.act == "silu_glu":
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    if cfg.act not in ("gelu", "relu2"):
        raise ValueError(f"unknown act {cfg.act}")
    s = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")}
    if cfg.act == "gelu":
        s["b1"] = ("mlp",)
        s["b2"] = ("embed",)
    return s


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


def embed_specs(cfg) -> Specs:
    # the vocab tables' d_model dim is `table_embed`, which no rule set
    # shards over `data` (the reference's note at its embed_init)
    s = {"tok": ("vocab", "table_embed")}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("table_embed", "vocab")
    return s


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p.get("lm_head")
    if w is None:
        w = p["tok"].T
    return (x @ w).float()


def lm_logits_sharded(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``lm_logits`` under the reference's name for the train and prefill
    calls, which constrain the activations to ``embed_act`` and the
    logits to ``vocab_act``. ``shard_activation`` returns its input in
    the port, so the values are ``lm_logits``'."""
    x = shd(x, "batch", None, "embed_act")
    return shd(lm_logits(p, x), "batch", None, "vocab_act")
