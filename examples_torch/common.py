"""The examples' substrate: small LMs trained in-framework + Q/K/V capture.

PyTorch counterpart of the eight names of ``benchmarks/common.py`` and
``benchmarks/head_pruning.py`` that ``examples/pruning_sweep.py`` and
``examples/serve_hdp.py`` use: ``SEQ``, ``VOCAB``, ``model_cfg``,
``train_model``, ``eval_batches``, ``forward_with_attention``,
``capture_qkv``, ``agreement_with`` and ``theta_head_samples``. It
imports only the port (``repro_torch``), torch and numpy.

No checkpoint exists offline, so the examples run on small LMs **trained
in-framework** on the synthetic pipeline (planted bigrams and motifs ->
concentrated attention, the structure HDP exploits), at two scales:

* ``tiny`` — 2 layers x 2 heads, d 128 (BERT-Tiny's head count);
* ``base`` — 6 layers x 8 heads, d 256 (48 heads; BERT-Base direction).

Trained params are cached in ``CACHE_DIR`` (``.bench_cache/`` at the
repository root) as ``torch_{scale}_s{steps}.npz``, one array per leaf
keyed by its path in ``repro_torch.common.tree``'s order. The JAX
package's files there (``{scale}_s{steps}.npz``) hold other weights in
another layout and are never read.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import dense_attention_reference, hdp_attention
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")

SEQ = 128
VOCAB = 512


def model_cfg(scale: str) -> ModelConfig:
    """In-framework stand-ins for the paper's BERT-Tiny / BERT-Base pair."""
    if scale == "tiny":
        n_layers, n_heads, d = 2, 2, 128
    elif scale == "base":
        n_layers, n_heads, d = 6, 8, 256
    else:
        raise ValueError(scale)
    return ModelConfig(
        name=f"bench-{scale}", family="dense", n_layers=n_layers,
        d_model=d, n_heads=n_heads, n_kv_heads=n_heads, d_ff=4 * d,
        vocab_size=VOCAB, head_dim=d // n_heads, act="gelu",
        pos_emb="rope", norm="layernorm", dtype="float32", remat=False,
        attn_chunk=SEQ, hdp=None)


def _cache_path(scale: str, steps: int) -> str:
    return os.path.join(CACHE_DIR, f"torch_{scale}_s{steps}.npz")


def _save(path: str, params) -> None:
    leaves, paths = tree.flatten_with_paths(params)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{p: x.detach().cpu().numpy()
                     for p, x in zip(paths, leaves)})
    os.replace(tmp, path)


def _load(path: str, cfg: ModelConfig, device) -> Dict:
    like = registry.init_params(cfg, device="meta")
    want = tree.flatten_with_paths(like)
    with np.load(path) as z:
        if sorted(z.files) != sorted(want[1]):
            raise ValueError(f"{path}: leaves {sorted(z.files)} are not "
                             f"{cfg.name}'s {sorted(want[1])}")
        leaves = [torch.from_numpy(z[p]).to(device=device, dtype=m.dtype)
                  for m, p in zip(*want)]
    return tree.unflatten(like, leaves)


def _fit(cfg: ModelConfig, params, steps: int, batch: int, verbose: bool
         ) -> Tuple[Dict, List[float]]:
    """``steps`` AdamW steps from ``params`` on the synthetic stream
    (seed 3); returns (params, the loss of every step)."""
    dev = tree.leaves(params)[0].device
    src = make_source(DataConfig(VOCAB, SEQ, batch, seed=3,
                                 kind="synthetic"))
    ocfg = opt.OptConfig(peak_lr=1e-3, warmup_steps=20, decay_steps=steps)
    step_fn = make_train_step(cfg, ocfg)
    state = opt.init_opt_state(params)
    scale = cfg.name.removeprefix("bench-")
    t0 = time.perf_counter()
    losses = []
    for s in range(steps):
        tokens = torch.from_numpy(src.batch_at(s)).to(dev)
        params, state, m = step_fn(params, state, {"tokens": tokens})
        losses.append(m["loss"])
        if verbose and s % 100 == 0:
            print(f"  [{scale}] step {s} loss {float(m['loss']):.3f}",
                  flush=True)
    losses = [float(x) for x in losses]
    if verbose:
        print(f"  [{scale}] trained {steps} steps in "
              f"{time.perf_counter() - t0:.0f}s loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}", flush=True)
    return params, losses


def train_model(scale: str, steps: int = 400, batch: int = 16,
                verbose: bool = True, *, device="cuda"
                ) -> Tuple[ModelConfig, Dict]:
    """Train (or load cached) a small LM on ``device``; returns (cfg,
    params). The initial weights are ``registry.init_params(cfg, seed=7)``
    (a ``torch.Generator``'s draws, not the JAX package's
    ``PRNGKey(7)``), so the trained model is the port's own."""
    cfg = model_cfg(scale)
    device = L.resolve_device(device)
    path = _cache_path(scale, steps)
    if os.path.exists(path):
        return cfg, _load(path, cfg, device)
    os.makedirs(CACHE_DIR, exist_ok=True)
    params = registry.init_params(cfg, seed=7, device=device)
    params, _ = _fit(cfg, params, steps, batch, verbose)
    _save(path, params)
    return cfg, params


def eval_batches(n: int = 4, batch: int = 8,
                 seed: int = 1234) -> List[np.ndarray]:
    """Held-out batches (different seed stream than training)."""
    src = make_source(DataConfig(VOCAB, SEQ, batch, seed=seed,
                                 kind="synthetic"))
    return [src.batch_at(10_000 + i) for i in range(n)]


# ------------------------------------------- pluggable-attention forward
@torch.no_grad()
def forward_with_attention(cfg: ModelConfig, params, tokens,
                           attn_fn: Callable,
                           capture: Optional[List] = None) -> torch.Tensor:
    """Dense-family forward with attention = ``attn_fn(layer, q, k, v)``.

    q/k/v are [B,H,S,hd]; attn_fn returns the attention output in the same
    layout. When ``capture`` is a list, the per-layer {"q","k","v"} dict
    is appended to it. ``tokens`` (an array or tensor [B,S]) moves to the
    params' device. The logits equal ``registry.apply_train``'s
    (``tests/test_torch_examples_common.py``)."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(tokens, device=dev)
    S = tokens.shape[1]
    positions = torch.arange(S, device=dev)
    x = L.embed_tokens(params["embed"], tokens)
    for li in range(cfg.n_layers):
        lp = L.tree_index(params["layers"], li)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q = torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wq"])
        kk = torch.einsum("bsd,dnk->bsnk", h, lp["attn"]["wk"])
        vv = torch.einsum("bsd,dnk->bsnk", h, lp["attn"]["wv"])
        q = L.apply_rope(q, positions, cfg.rope_theta)
        kk = L.apply_rope(kk, positions, cfg.rope_theta)
        qh = q.transpose(1, 2)              # [B,H,S,hd]
        kh = kk.transpose(1, 2)
        vh = vv.transpose(1, 2)
        if capture is not None:
            capture.append({"q": qh, "k": kh, "v": vh})
        o = attn_fn(li, qh, kh, vh)
        x = x + torch.einsum("bshk,hkd->bsd", o.transpose(1, 2),
                             lp["attn"]["wo"])
        h2 = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.mlp_apply(cfg, lp["ffn"], h2)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(params["embed"], x)


def _dense(li, q, k, v):
    return dense_attention_reference(q, k, v, causal=True)


def capture_qkv(cfg: ModelConfig, params,
                tokens) -> List[Dict[str, torch.Tensor]]:
    """Per-layer Q/K/V [B,H,S,hd] under the exact dense forward."""
    cap: List[Dict[str, torch.Tensor]] = []
    forward_with_attention(cfg, params, tokens, _dense, capture=cap)
    return cap


def agreement_with(cfg, params, attn_fn: Callable, batches) -> float:
    """Top-1 agreement of a pluggable-attention forward vs exact dense."""
    agree = total = 0
    for b in batches:
        ad = forward_with_attention(cfg, params, b, _dense).argmax(-1)
        av = forward_with_attention(cfg, params, b, attn_fn).argmax(-1)
        agree += int((ad == av).sum())
        total += ad.numel()
    return agree / max(total, 1)


def theta_head_samples(cfg, params, batches, hdp: HDPConfig) -> np.ndarray:
    """Observed theta_head across layers/batches/heads (for thresholds)."""
    vals = []
    for b in batches:
        for c in capture_qkv(cfg, params, b):
            _, st = hdp_attention(c["q"], c["k"], c["v"], hdp)
            vals.append(st.theta_head.cpu().numpy().ravel())
    return np.concatenate(vals)
