"""Mixture-of-Experts FFN, GShard-style grouped dispatch with dropping.

PyTorch counterpart of ``repro.models.moe``: top-K routing (olmoe: 64
experts, top-8) with an optional always-on shared expert (llama4-scout:
16 experts, top-1 + shared). Dispatch and combine are one-hot products,
as in the reference: every expert runs over its capacity buffer as a
batched matmul, and a token past its expert's capacity is dropped
(capacity is enforced per group of ``Sg`` tokens, s-major, so earlier
tokens win a full expert). Every shape is static and nothing is read
back to the host, so the layer runs inside the decode step's CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distribution.collectives import group_mean
from repro_torch.models import layers as L

F32 = torch.float32


def moe_init(cfg, gen: torch.Generator, dtype, device) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": L.dense_init(gen, (d, e), dtype, device),
        "w_gate": L.dense_init(gen, (e, d, f), dtype, device, in_axis=1),
        "w_up": L.dense_init(gen, (e, d, f), dtype, device, in_axis=1),
        "w_down": L.dense_init(gen, (e, f, d), dtype, device, in_axis=1),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": L.dense_init(gen, (d, fs), dtype, device),
                       "w_up": L.dense_init(gen, (d, fs), dtype, device),
                       "w_down": L.dense_init(gen, (fs, d), dtype, device)}
    return p


def param_specs(cfg) -> Dict:
    """Logical axes of ``moe_init``'s leaves (the reference's spec half)."""
    s = {"router": ("embed", "experts"),
         "w_gate": ("experts", "embed", "mlp"),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if cfg.n_shared_experts:
        s["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed")}
    return s


def group_size(cfg, S: int) -> int:
    """Tokens per capacity group ``Sg`` of a length-S sequence (the
    reference's rule): the whole sequence, unless the ungrouped [S,E,C]
    dispatch of a many-expert model would pass 64 Mi entries; then
    ``min(moe_group, max(S // 16, 128), S)``, halved until it divides S."""
    E, K = cfg.n_experts, cfg.n_experts_active
    cap0 = max(1, int(cfg.capacity_factor * S * K / E))
    if E < 32 or S * E * cap0 <= 64 * 2 ** 20:
        Sg = S
    else:
        Sg = min(cfg.moe_group, max(S // 16, 128), S)
    while S % Sg:
        Sg //= 2
    return Sg


def route(cfg, p, xg: torch.Tensor):
    """Router of xg [B,G,Sg,D]: (probs [B,G,Sg,E] fp32, top_p and top_i
    [B,G,Sg,K], onehot_e [B,G,Sg,K,E] fp32, the slot of each choice in
    its expert's buffer [B,G,Sg,K] and whether it fits)."""
    B, G, Sg, _ = xg.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    capacity = max(1, int(cfg.capacity_factor * Sg * K / E))
    logits = torch.einsum("bgsd,de->bgse", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # the K largest, ties to the lower expert index (jax.lax.top_k's
    # order; torch.topk promises none): a stable descending sort
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :K], top_i[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=xg.device)
    onehot_e = (top_i[..., None] == experts).to(F32)
    # position of each (token, choice) in its expert's buffer, s-major
    flat = onehot_e.reshape(B, G, Sg * K, E)
    pos = torch.cumsum(flat, dim=2) - flat
    pos = (pos * flat).sum(-1).reshape(B, G, Sg, K).to(torch.int64)
    return probs, top_p, top_i, onehot_e, pos, pos < capacity, capacity


def moe_apply(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D] in x's dtype, aux loss scalar fp32)."""
    B, S, D = x.shape
    E = cfg.n_experts
    Sg = group_size(cfg, S)
    G = S // Sg
    xg = x.reshape(B, G, Sg, D)
    probs, top_p, _, onehot_e, pos, fits, capacity = route(cfg, p, xg)
    slots = torch.arange(capacity, device=x.device)
    onehot_c = ((pos[..., None] == slots) & fits[..., None]).to(F32)

    # dispatch/combine [B,G,Sg,E,C]; top_p is folded into the expert
    # one-hot before the product over K (a pair (token, expert) occurs at
    # most once among a token's choices, so this equals the reference's
    # three-operand product and never builds [B,G,Sg,K,E,C])
    dispatch = torch.einsum("bgske,bgskc->bgsec", onehot_e, onehot_c)
    combine = torch.einsum("bgske,bgskc->bgsec",
                           onehot_e * top_p[..., None], onehot_c)

    # one token per (expert, slot) at most: the dispatch product is exact
    # in x's dtype, as the reference's fp32 accumulation is
    xin = torch.einsum("bgsec,bgsd->bgecd", dispatch.to(x.dtype), xg)
    gate = torch.einsum("bgecd,edf->bgecf", xin, p["w_gate"])
    if cfg.act == "silu_glu":
        h = F.silu(gate) * torch.einsum("bgecd,edf->bgecf", xin, p["w_up"])
    else:
        h = F.gelu(gate, approximate="tanh")
    xout = torch.einsum("bgecf,efd->bgecd", h, p["w_down"])
    y = torch.einsum("bgsec,bgecd->bgsd", combine.to(x.dtype), xout)
    y = y.reshape(B, S, D)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]

    # GShard load-balancing aux loss: E * sum_e f_e * P_e, the shares over
    # every row of the batch (a data-parallel rank holds some of them)
    f_e = group_mean(onehot_e.sum(3).mean(dim=(0, 1, 2)))      # routed share
    p_e = group_mean(probs.mean(dim=(0, 1, 2)))
    aux = E * torch.sum(f_e * p_e) * cfg.router_aux_weight
    return y, aux
