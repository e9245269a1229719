"""Mamba2 (SSD) layer, the backbone of the zamba2 hybrid.

PyTorch counterpart of ``repro.models.mamba2``. The state-space
recurrence per head keeps S [P, N]: ``S_t = exp(dt_t A) S_{t-1} +
dt_t x_t (x) B_t`` and ``y_t = S_t C_t``, after a width-4 causal
depthwise conv on the input branch. Attention-free, so HDP does not
apply. A prompt whose length the SSD chunk divides runs the chunked dual
form (``_ssd_chunked``), any other length (decode included) the
per-step recurrence (``_ssd_scan``), by the reference's own rule.
``A_log`` stays fp32 in a bf16 model, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.loops import gathered, trips
from repro_torch.models import layers as L

F32 = torch.float32


def d_inner(cfg) -> int:
    return 2 * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def layer_init(cfg, gen, dtype, device) -> Dict:
    d, di, n, h = cfg.d_model, d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    dt = L.torch_dtype(dtype)
    return {
        "Wz": L.dense_init(gen, (d, di), dt, device),
        "Wx": L.dense_init(gen, (d, di), dt, device),
        "WB": L.dense_init(gen, (d, n), dt, device),
        "WC": L.dense_init(gen, (d, n), dt, device),
        "Wdt": L.dense_init(gen, (d, h), dt, device),
        "dt_bias": torch.zeros((h,), dtype=dt, device=device),
        "A_log": torch.zeros((h,), dtype=F32, device=device),
        "D_skip": torch.ones((h,), dtype=dt, device=device),
        "conv_w": 0.1 * torch.ones((cfg.ssm_conv, di), dtype=dt,
                                   device=device),
        "norm_w": torch.ones((di,), dtype=dt, device=device),
        "Wo": L.dense_init(gen, (di, d), dt, device),
    }


def param_specs(cfg) -> Dict:
    """Logical axes of ``layer_init``'s leaves (the reference's spec
    half)."""
    return {
        "Wz": ("embed", "mlp"), "Wx": ("embed", "mlp"),
        "WB": ("embed", "state"), "WC": ("embed", "state"),
        "Wdt": ("embed", "heads"), "dt_bias": ("heads",),
        "A_log": ("heads",), "D_skip": ("heads",),
        "conv_w": ("conv", "mlp"), "norm_w": ("mlp",),
        "Wo": ("mlp", "embed"),
    }


def _causal_conv(x, w, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv by shifted adds in x's dtype, summed in
    Python's order (0 + t0 + t1 + ...) as the reference sums. x [B,T,di];
    w [W,di]; conv_state [B,W-1,di]: the previous segment's trailing
    inputs (None: zeros). Returns (y, new_conv_state)."""
    W = w.shape[0]
    B, T, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                # [B, T+W-1, di]
    y = sum(xp[:, i:i + T] * w[i] for i in range(W))
    return y, xp[:, xp.shape[1] - (W - 1):]


def _ssd_scan(xh, dt, decay, Bm, Cm, s0):
    """The per-step recurrence: xh [B,T,H,P]; dt, decay [B,T,H]; Bm, Cm
    [B,T,N]; s0 [B,H,P,N]. Returns (y [B,T,H,P], the final state)."""
    S = s0
    ys = []
    for t in trips(xh.shape[1], carry=True):   # a trace: four steps
        xdt = xh[:, t] * dt[:, t, :, None]              # [B,H,P]
        S = decay[:, t, :, None, None] * S \
            + xdt[..., None] * Bm[:, t, None, None, :]  # outer product
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    return gathered(ys, xh.shape[1], 1), S


def _ssd_chunked(xh, dt, log_decay, Bm, Cm, s0, chunk: int):
    """The SSD chunked dual form (Mamba2's own parallel algorithm): within
    a chunk of L steps an O(L^2) masked product, the state carried across
    chunks. The decay ratios are exps of log-space cumsums clipped at 0
    (dt*A <= 0, so no argument is positive).

    xh [B,T,H,P]; dt [B,T,H]; log_decay = dt*A [B,T,H]; Bm, Cm [B,T,N];
    s0 [B,H,P,N]. Returns (y [B,T,H,P], S_final)."""
    B, T, H, P = xh.shape
    Lc = min(chunk, T)
    if T % Lc:
        raise ValueError(f"T={T} not divisible by ssd chunk {Lc}")
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=xh.device))
    S = s0
    ys = []
    for c in trips(T // Lc, carry=True):   # a trace: four chunks
        sl = slice(c * Lc, (c + 1) * Lc)
        xc, dtc, ldc, bc, cc = (xh[:, sl], dt[:, sl], log_decay[:, sl],
                                Bm[:, sl], Cm[:, sl])
        lcum = torch.cumsum(ldc, dim=1)               # [B,L,H]
        # inter-chunk: y_t += exp(lcum_t) * (S_0 . C_t)
        y = torch.einsum("bhpn,bln->blhp", S, cc) * torch.exp(lcum)[..., None]
        # intra-chunk: G[t,j] = exp(lcum_t - lcum_j) dt_j (C_t.B_j), j<=t
        cb = torch.einsum("bln,bjn->blj", cc, bc)     # [B,L,L]
        ratio = torch.exp(torch.clamp(lcum[:, :, None] - lcum[:, None, :],
                                      max=0.0))       # [B,L,L,H]
        g = cb[..., None] * ratio * dtc[:, None]      # [B,L(t),L(j),H]
        g = torch.where(mask[None, :, :, None], g, 0.0)
        y = y + torch.einsum("bljh,bjhp->blhp", g, xc)
        # carry: S_L = exp(lcum_L) S_0 + sum_j exp(lcum_L - lcum_j) dt_j x_j B_j
        wj = torch.exp(lcum[:, -1:, :] - lcum) * dtc  # [B,L,H]
        S = S * torch.exp(lcum[:, -1])[..., None, None] + torch.einsum(
            "blhp,bln->bhpn", xc * wj[..., None], bc)
        ys.append(y)
    return gathered(ys, T // Lc, 1, cat=True), S


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def layer_apply(cfg, p, x, cache: Optional[Dict]) -> Tuple:
    """x [B,T,D] -> (y [B,T,D], new cache {"S","conv"}); ``cache`` (this
    layer's view, or None for zeros) is read, not written."""
    B, T, D = x.shape
    di, N, H, P = (d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg),
                   cfg.ssm_head_dim)
    z = x @ p["Wz"]
    xi = x @ p["Wx"]
    conv_state = cache["conv"] if cache is not None else None
    xi, new_conv = _causal_conv(xi, p["conv_w"], conv_state)
    xi = F.silu(xi)

    dt = _softplus((x @ p["Wdt"] + p["dt_bias"]).float())
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                         # [B,T,H]
    Bm = (x @ p["WB"]).float()
    Cm = (x @ p["WC"]).float()
    xh = xi.reshape(B, T, H, P).float()

    s0 = cache["S"] if cache is not None else torch.zeros(
        (B, H, P, N), dtype=F32, device=x.device)
    chunk = cfg.ssm_chunk
    if T > 1 and T % min(chunk, T) == 0:
        y, S = _ssd_chunked(xh, dt, dt * A, Bm, Cm, s0.float(), chunk)
    else:
        y, S = _ssd_scan(xh, dt, decay, Bm, Cm, s0.float())
    y = y + p["D_skip"].float()[None, None, :, None] * xh
    y = y.reshape(B, T, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_w"])
    return y @ p["Wo"], {"S": S, "conv": new_conv}


def init_cache(cfg, batch: int, dtype=None, device=None) -> Dict:
    di, N, H, P = (d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg),
                   cfg.ssm_head_dim)
    dt = L.torch_dtype(dtype or cfg.dtype)
    return {"S": torch.zeros((batch, H, P, N), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dt,
                                device=device)}


def cache_specs() -> Dict:
    return {"S": ("batch", "heads", None, None),
            "conv": ("batch", None, "mlp_act")}


def param_count(cfg) -> int:
    d, di, n, h = cfg.d_model, d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    return (2 * d * di + 2 * d * n + d * h + 3 * h
            + cfg.ssm_conv * di + di + di * d)
