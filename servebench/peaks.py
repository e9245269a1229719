"""The table of peaks, and the model FLOPs the whole-step share of the
peak counts.

Peaks are NVIDIA's data-sheet dense rates of the H100 SXM part (no
sparsity), which assume its full 700 W power limit; a run prints the
card's own limit beside any share of them.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_s": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(kind: str) -> Optional[Dict]:
    return PEAKS.get(kind)


def active_params(m: Dict) -> int:
    """Parameters a token's dense work runs through (no embedding lookup):
    attention projections, its K routed experts and the router (or the
    MLP), and the output head."""
    d, H, N, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    hd = m["head_dim"] or d // H
    attn = 2 * d * H * hd + 2 * d * N * hd
    if m["n_experts"]:
        ffn = m["n_experts_active"] * 3 * d * f + d * m["n_experts"]
    else:
        ffn = 3 * d * f
    return m["n_layers"] * (attn + ffn) + d * m["vocab_size"]


def token_flops(m: Dict, context: float) -> float:
    """Model FLOPs of one token at ``context`` visible keys: 2 x active
    params, plus causal attention's two products (QK^T and PV) over the
    context in every layer."""
    d, H = m["d_model"], m["n_heads"]
    hd = m["head_dim"] or d // H
    return 2.0 * active_params(m) + 4.0 * context * H * hd * m["n_layers"]


def prompt_flops(m: Dict, lo: int, hi: int) -> float:
    """Model FLOPs of prompt positions [lo, hi) each at its own causal
    context (position + 1 keys)."""
    n = hi - lo
    ctx_sum = (hi * (hi + 1) - lo * (lo + 1)) / 2.0
    d, H = m["d_model"], m["n_heads"]
    hd = m["head_dim"] or d // H
    return 2.0 * active_params(m) * n + 4.0 * ctx_sum * H * hd * m["n_layers"]
