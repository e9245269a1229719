"""Plain PyTorch reference of the served transformer, for the benchmark's
check of what the timed path produced.

It imports nothing of the program under test (neither ``repro_torch`` nor
the JAX package): the arithmetic below is written out from the model's
published description and the engine's documented serving rules, and a
test holds it against the engine on the CPU. It reads the configuration
file's shapes and the weights dict that the benchmark drew, in the port's
layout (``embed``, ``layers`` with a leading layer axis, ``final_norm``).

It computes in the configuration's own arithmetic: activations in its
dtype (bf16 for both cells), rounded where the model rounds them (after
every projection, norm, rope, residual add and expert product), the
attention's scores, softmax and P.V and the router in float32, TF32
off.

``pool_check`` follows a served request from the program's own pool:

* the prefill forward calls the engine made for the prompt (a padded
  bucket, or chunks at an offset, see ``replay.py``), each with the
  engine's HDP prefill attention (integer scout over block_q x block_k
  blocks, row-balanced block pruning, the head gate over the call, the
  QK^T - FQ.FK^T approximation) and, for a mixture of experts, the
  capacity of the call's own token count;
* K and V snapped to the int8 pool grid, as the pool stores them;
* every decode step, teacher-forced with the served tokens: the decode
  HDP over pages (stage 1: integer scout per page, stage 2: pages kept
  per head, head gate; stage 3: the approximate scores on the kept
  pages), and the logits of the step.

Each layer's attention takes the program's pool K/V as its context, and
the codes the reference writes are compared with the pool's at every
layer. A forward pass of these random-weight models turns a difference
in the last bit of one activation into a different token within a few
layers when each position's context is its own computation (``PERF.md``
section 2 gives the readings); from the pool's context a difference
stays in the position where it arose.

``Prec`` sets the arithmetic: the reference runs ``Prec(dtype)``; the
control of the check runs the same code with every projection's and
expert product's operands one precision below.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG = -1e30
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
#: the control's operand precision, one step below each configured dtype
BELOW = {"bfloat16": "fp8", "float16": "fp8", "float32": "bfloat16"}


class Prec:
    """The arithmetic of a forward pass: activations in ``dtype`` (the
    configuration's), rounded where the model rounds them; with ``low``
    the operands of every projection and expert product are rounded
    below it first ("fp8": float8 e4m3 with a scale per weight matrix
    and per activation row, amax / 448, the W8A8 path a serving stack
    on this card would take; "bfloat16"), the product taken in float32
    and its result rounded to ``dtype``."""

    def __init__(self, dtype: str, low: Optional[str] = None):
        if low not in (None, "fp8", "bfloat16"):
            raise ValueError(f"unknown precision {low!r}")
        self.adt = DTYPES[dtype]
        self.low = low

    def _round(self, x: torch.Tensor, dims) -> torch.Tensor:
        if self.low == "bfloat16":
            return x.to(torch.bfloat16).to(F32)
        amax = x.abs().amax(dim=dims, keepdim=True)
        s = torch.clamp(amax, min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(F32) * s

    def weight(self, w: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """``lead`` leading axes index separate matrices (experts)."""
        if self.low is None:
            return w.to(self.adt)
        return self._round(w.to(F32), tuple(range(lead, w.dim())))

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.low is None:
            return x @ w
        return (self._round(x.to(F32), (-1,)) @ w).to(self.adt)

    def bmm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.low is None:
            return torch.bmm(x, w)
        return torch.bmm(self._round(x.to(F32), (-1,)), w).to(self.adt)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The configuration file's ``model`` and ``hdp`` groups."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    n_experts: int
    n_experts_active: int
    capacity_factor: float
    moe_group: int
    qk_norm: bool
    rope_theta: float
    hdp: Dict

    @staticmethod
    def from_config(conf: Dict) -> "Shapes":
        m = conf["model"]
        for key, want in (("family", ("dense", "moe")), ("act", ("silu_glu",)),
                          ("norm", ("rmsnorm",)), ("pos_emb", ("rope",))):
            if m[key] not in want:
                raise NotImplementedError(f"reference: {key}={m[key]!r}")
        if m["qkv_bias"] or m["sliding_window"] or m["tie_embeddings"] \
                or m["n_shared_experts"]:
            raise NotImplementedError("reference: bias, window, tied "
                                      "embeddings or a shared expert")
        hdp = dict(conf["hdp"])
        if hdp["approx_softmax"] or not hdp["enabled"]:
            raise NotImplementedError("reference: HDP on, exact softmax")
        hd = m["head_dim"] or m["d_model"] // m["n_heads"]
        return Shapes(m["n_layers"], m["d_model"], m["n_heads"],
                      m["n_kv_heads"], hd, m["d_ff"],
                      m["vocab_size"], m["n_experts"], m["n_experts_active"],
                      m["capacity_factor"], m["moe_group"], m["qk_norm"],
                      m["rope_theta"], hdp)


# ---------------------------------------------------------------- numerics
def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm computed in float32, the result in x's dtype."""
    xf = x.to(F32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.to(F32)).to(x.dtype)


def rope(x, pos, theta: float):
    """Rotary code on [S, heads, hd] at absolute positions [S] (halves
    rotated, not interleaved), computed in float32, in x's dtype."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=F32,
                                       device=x.device), exps)
    ang = pos.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def fixed_split(x, int_bits: int, frac_bits: int):
    """Signed fixed point Q(int_bits).(frac_bits), round half to even,
    clamped; returns (value, integer part toward zero, fraction)."""
    scale = 2.0 ** frac_bits
    q = torch.clamp(torch.round(x * scale) / scale, -(2.0 ** int_bits),
                    2.0 ** int_bits - 2.0 ** (-frac_bits))
    i = torch.trunc(q)
    return q, i, q - i


def pool_snap(x, int_bits: int):
    """What the int8 pool keeps of x: codes round(x / step) clamped to
    +/-127 on the static step 2^(int_bits - 7), times the step."""
    s = 2.0 ** (int_bits - 7)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def row_threshold(theta, rho: float, valid):
    """Alg. 2 line 15 over the valid blocks of the last axis."""
    big = torch.finfo(F32).max
    tmax = torch.where(valid, theta, -big).amax(-1, keepdim=True)
    tmin = torch.where(valid, theta, big).amin(-1, keepdim=True)
    cnt = torch.clamp(valid.sum(-1, keepdim=True).to(F32), min=1.0)
    tmean = torch.where(valid, theta, 0.0).sum(-1, keepdim=True) / cnt
    r = torch.full((), rho, dtype=F32, device=theta.device)
    if rho >= 0:
        return r * tmax + (1.0 - r) * tmean
    return -r * tmin + (1.0 + r) * tmean


def _softmax_masked(s, keep):
    s = torch.where(keep, s, NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(keep, p, 0.0)
    return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)


def hdp_prefill(q, q_pos, k, v, kv_end: int, hdp: Dict):
    """HDP attention of one prefill call. q [Sq, N, G, hd] at positions
    q_pos [Sq]; k, v [>= kv_end, N, hd] float32 values on the pool grid,
    of which positions < kv_end are valid; causal. Blocks of block_q
    query rows by block_k keys; the head gate sums the scout over the
    whole call. Scores in float32; the probabilities are rounded to q's
    dtype (the request cache's) before P.V; the output is in q's dtype."""
    adt = q.dtype
    q = q.to(F32)
    Sq, N, G, hd = q.shape
    bq, bk = hdp["block_q"], hdp["block_k"]
    ib, fb = hdp["int_bits"], hdp["frac_bits"]
    Skp = -(-kv_end // bk) * bk
    Sqp = -(-Sq // bq) * bq
    dev = q.device
    k = _pad0(k[:kv_end], Skp)
    v = _pad0(v[:kv_end], Skp)
    qp = _pad0(q, Sqp)
    qpos = torch.full((Sqp,), -1, dtype=torch.int64, device=dev)
    qpos[:Sq] = q_pos
    kpos = torch.arange(Skp, device=dev)
    kval = kpos < kv_end
    qq, iq, fq = fixed_split(qp, ib, fb)
    kq, ik, fk = fixed_split(k, ib, fb)
    nk = Skp // bk
    theta_head = torch.zeros((N, G), dtype=F32, device=dev)
    n_valid = 0
    keeps, valids = [], []
    for i in range(Sqp // bq):
        rows = slice(i * bq, (i + 1) * bq)
        valid = (qpos[rows, None] >= 0) & kval[None, :]
        if hdp["causal"]:
            valid = valid & (qpos[rows, None] >= kpos[None, :])
        s_int = torch.einsum("qngd,knd->ngqk", iq[rows], ik)
        s_int = torch.where(valid, s_int, 0.0).abs()
        theta = s_int.reshape(N, G, bq, nk, bk).sum(dim=(2, 4))   # [N,G,nk]
        bvalid = valid.reshape(bq, nk, bk).any(-1).any(0)         # [nk]
        if hdp["block_pruning"]:
            thr = row_threshold(theta, hdp["rho_b"], bvalid)
            keep = (theta >= thr) & bvalid
        else:
            keep = bvalid.expand(theta.shape)
        theta_head += torch.where(bvalid, theta, 0.0).sum(-1)
        n_valid += int(valid.sum())
        keeps.append(keep)
        valids.append(valid)
    if hdp["normalize_head_score"]:
        theta_head = theta_head / max(n_valid, 1)
    head_kept = (theta_head > hdp["tau_h"]) if hdp["head_pruning"] \
        else torch.ones_like(theta_head, dtype=torch.bool)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((Sqp, N, G, hd), dtype=F32, device=dev)
    for i in range(Sqp // bq):
        rows = slice(i * bq, (i + 1) * bq)
        s = torch.einsum("qngd,knd->ngqk", qq[rows], kq)
        if hdp["approx"]:
            s = s - torch.einsum("qngd,knd->ngqk", fq[rows], fk)
        keep_e = keeps[i].repeat_interleave(bk, dim=-1)[:, :, None, :] \
            & valids[i]
        p = _softmax_masked(s * scale, keep_e).to(adt).to(F32)
        out[rows] = torch.einsum("ngqk,knd->qngd", p, v)
    out = out * head_kept[None, :, :, None].to(F32)
    return out[:Sq].to(adt)


def hdp_decode(q, pos, k, v, hdp: Dict):
    """Decode HDP of single-token steps, one row per step: q [n, N, G,
    hd] at positions pos [n]; k, v [>= max(pos) + 1, N, hd] the pool's
    values. Pages of block_k positions; each row's scout pools its own
    query only, a page's keep is per query head, the head gate divides
    by the row's valid keys. Float32 inside (the probabilities of an int8
    pool are not rounded); the output is in q's dtype."""
    adt = q.dtype
    q = q.to(F32)
    n, N, G, hd = q.shape
    bk = hdp["block_k"]
    ib, fb = hdp["int_bits"], hdp["frac_bits"]
    P = -(-(int(pos.max()) + 1) // bk) * bk
    k = _pad0(k[:P], P)
    v = _pad0(v[:P], P)
    dev = q.device
    qq, iq, fq = fixed_split(q, ib, fb)
    kq, ik, fk = fixed_split(k, ib, fb)
    kpos = torch.arange(P, device=dev)
    valid = kpos[None, :] <= pos[:, None]                          # [n, P]
    nk = P // bk
    s_int = torch.einsum("ingd,knd->ingk", iq, ik)
    s_int = torch.where(valid[:, None, None, :], s_int, 0.0).abs()
    theta = s_int.reshape(n, N, G, nk, bk).sum(-1)                 # [n,N,G,nk]
    bvalid = valid.reshape(n, nk, bk).any(-1)[:, None, None, :]
    if hdp["block_pruning"]:
        thr = row_threshold(theta, hdp["rho_b"], bvalid)
        keep = (theta >= thr) & bvalid
    else:
        keep = bvalid.expand(theta.shape)
    theta_head = torch.where(bvalid, theta, 0.0).sum(-1)
    if hdp["normalize_head_score"]:
        theta_head = theta_head / (pos.to(F32) + 1.0)[:, None, None]
    head_kept = (theta_head > hdp["tau_h"]) if hdp["head_pruning"] \
        else torch.ones_like(theta_head, dtype=torch.bool)
    s = torch.einsum("ingd,knd->ingk", qq, kq)
    if hdp["approx"]:
        s = s - torch.einsum("ingd,knd->ingk", fq, fk)
    keep_e = keep.repeat_interleave(bk, dim=-1) & valid[:, None, None, :]
    p = _softmax_masked(s * (1.0 / math.sqrt(hd)), keep_e)
    out = torch.einsum("ingk,knd->ingd", p, v)
    return (out * head_kept[..., None].to(F32)).to(adt)


def _pad0(x, n: int):
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])


def group_size(shp: Shapes, S: int) -> int:
    """Tokens per capacity group of a length-S call: the whole call,
    unless the ungrouped dispatch of a many-expert model would pass 64 Mi
    entries (GShard's grouping, as the port documents it)."""
    E, K = shp.n_experts, shp.n_experts_active
    cap0 = max(1, int(shp.capacity_factor * S * K / E))
    if E < 32 or S * E * cap0 <= 64 * 2 ** 20:
        Sg = S
    else:
        Sg = min(shp.moe_group, max(S // 16, 128), S)
    while S % Sg:
        Sg //= 2
    return Sg


def moe(x, lw, shp: Shapes, prec: Prec):
    """Top-K experts of x [R, S, D] (R independent rows of S tokens):
    float32 router and softmax, the K largest (ties to the lower expert),
    renormalised; GShard capacity per group of ``group_size(S)`` tokens,
    earlier tokens first, a choice past its expert's capacity adding
    nothing. Every expert runs over its capacity buffer; a token's
    output is its choices' outputs weighted by the routing probabilities
    rounded to x's dtype, summed in float32 in expert order and rounded
    once."""
    R, S, D = x.shape
    E, K = shp.n_experts, shp.n_experts_active
    Sg = group_size(shp, S)
    cap = max(1, int(shp.capacity_factor * Sg * K / E))
    groups = R * (S // Sg)
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    probs = torch.softmax(xf.to(F32) @ lw["router"].to(F32), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_i.reshape(groups, Sg * K), E)      # s-major
    slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    slot = slot.reshape(T, K)
    fits = slot < cap
    row = (torch.arange(T, device=x.device) // Sg)[:, None] * cap + slot
    tok, ch = torch.nonzero(fits, as_tuple=True)
    xin = xf.new_zeros((E, groups * cap, D))
    xin[top_i[tok, ch], row[tok, ch]] = xf[tok]
    h = F.silu(prec.bmm(xin, lw["w_gate"])) * prec.bmm(xin, lw["w_up"])
    xo = prec.bmm(h, lw["w_down"])
    w = torch.where(fits, top_p.to(x.dtype).to(F32), 0.0)
    order = torch.argsort(top_i, dim=-1)
    y = torch.zeros((T, D), dtype=F32, device=x.device)
    for j in range(K):
        e = top_i.gather(1, order[:, j:j + 1])[:, 0]
        r = torch.clamp(row.gather(1, order[:, j:j + 1])[:, 0], max=groups * cap - 1)
        y = y + w.gather(1, order[:, j:j + 1]) * xo[e, r].to(F32)
    return y.to(x.dtype).reshape(R, S, D)


def mlp(x, lw, prec: Prec):
    h = F.silu(prec.mm(x, lw["w_gate"])) * prec.mm(x, lw["w_up"])
    return prec.mm(h, lw["w_down"])


# ------------------------------------------------------------------ model
def _layer(W, li: int, shp: Shapes, prec: Prec, dev) -> Dict:
    L = W["layers"]
    d, H, N, hd = shp.d_model, shp.n_heads, shp.n_kv_heads, shp.head_dim

    def f(t):
        return t[li].to(device=dev)

    a, ffn = L["attn"], L["ffn"]
    lw = {"wq": prec.weight(f(a["wq"]).reshape(d, H * hd)),
          "wk": prec.weight(f(a["wk"]).reshape(d, N * hd)),
          "wv": prec.weight(f(a["wv"]).reshape(d, N * hd)),
          "wo": prec.weight(f(a["wo"]).reshape(H * hd, d)),
          "ln1": f(L["ln1"]["w"]), "ln2": f(L["ln2"]["w"])}
    if shp.qk_norm:
        lw["q_norm"], lw["k_norm"] = f(a["q_norm"]), f(a["k_norm"])
    lead = 1 if shp.n_experts else 0
    for name in ("w_gate", "w_up", "w_down"):
        lw[name] = prec.weight(f(ffn[name]), lead)
    if shp.n_experts:
        lw["router"] = f(ffn["router"])
    return lw


def _qkv(x, pos, lw, shp: Shapes, prec: Prec):
    """q [S, N, G, hd] in the activation dtype; k, v [S, N, hd] float32
    values on the pool grid."""
    S = x.shape[0]
    H, N, hd = shp.n_heads, shp.n_kv_heads, shp.head_dim
    h = rms_norm(x, lw["ln1"])
    q = prec.mm(h, lw["wq"]).reshape(S, H, hd)
    k = prec.mm(h, lw["wk"]).reshape(S, N, hd)
    v = prec.mm(h, lw["wv"]).reshape(S, N, hd)
    if shp.qk_norm:
        q, k = rms_norm(q, lw["q_norm"]), rms_norm(k, lw["k_norm"])
    q, k = rope(q, pos, shp.rope_theta), rope(k, pos, shp.rope_theta)
    ib = shp.hdp["int_bits"]
    return (q.reshape(S, N, H // N, hd), pool_snap(k.to(F32), ib),
            pool_snap(v.to(F32), ib))


def _block(x, pos, attend, lw, shp: Shapes, prec: Prec, rows: bool):
    """One layer on x [S, D] at positions pos; ``attend(q, k, v)`` is the
    attention. ``rows``: each token its own MoE group (decode)."""
    S = x.shape[0]
    q, k, v = _qkv(x, pos, lw, shp, prec)
    o = attend(q, k, v)
    x = x + prec.mm(o.reshape(S, -1), lw["wo"])
    h = rms_norm(x, lw["ln2"])
    if shp.n_experts:
        m = moe(h[:, None] if rows else h[None], lw, shp, prec).reshape(S, -1)
    else:
        m = mlp(h, lw, prec)
    return x + m


@dataclasses.dataclass
class PoolSeq:
    """A served request with the program's pool pages of it, read when it
    finished: int8 codes of K and V [L, T, N, hd] for positions [0, T),
    T = len(prompt) - 1 + len(decode), and their page scales [L, pages,
    N] (pages of ``page`` positions)."""
    uid: int
    prompt: np.ndarray
    calls: List[Tuple[int, np.ndarray]]
    decode: np.ndarray
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page: int

    def values(self, li: int, dev):
        """Layer ``li``'s K and V as float32 values."""
        T = self.k.shape[1]

        def deq(codes, scale):
            sc = scale[li].to(dev, F32).repeat_interleave(self.page, dim=0)
            return codes[li].to(dev, F32) * sc[:T, :, None]

        return deq(self.k, self.k_scale), deq(self.v, self.v_scale)


@torch.no_grad()
def pool_check(W, shp: Shapes, seq: PoolSeq, prec: Prec, device
               ) -> Tuple[List[Tuple[int, int]], torch.Tensor]:
    """The program's pool codes of ``seq`` against the reference's at
    every layer, and the reference's logits of every decode step.

    Returns (codes that differ, codes compared) per layer, and the logits
    [n, V] (float32) of the n decode steps, each step's input the served
    token before it (the prompt's last token first).

    Layer 0's K and V at every position depend on the position's token
    alone (the prompt's, the served tokens teacher-forced after it), so
    every code is compared: the tokens, the embedding, the projections,
    the int8 writes of prefill and decode, and the prefix cache's shared
    pages. Each later layer is reached from the layer before with the
    pool's own K/V as every attention's context (the program's state,
    not the reference's), so a difference in one position's hidden state
    does not spread to the others: the request's own prefill calls whole
    (padding included, so each call's HDP blocks, head gate and expert
    capacity are the engine's; the context at and past the prompt's last
    position, which the pool holds from the decode, is the call's own),
    with the codes of the rows before the prompt's last position
    compared, and every decode step (HDP decode over the pool's pages).
    The decode steps' hidden states go on through the final norm and the
    LM head to the logits the served tokens are judged by."""
    dev = torch.device(device)
    hdp = shp.hdp
    tok = W["embed"]["tok"]

    def embed(ids):
        return tok[torch.as_tensor(ids, device=tok.device)].to(dev, prec.adt)

    plen, n = len(seq.prompt), len(seq.decode)
    last = plen - 1
    dec_in = np.concatenate([seq.prompt[-1:], seq.decode[:-1]])
    xs = [embed(t) for _, t in seq.calls]
    xd = embed(dec_in)
    pos_d = last + torch.arange(n, device=dev)
    out = []
    for li in range(shp.n_layers):
        lw = _layer(W, li, shp, prec, dev)
        kp, vp = seq.values(li, dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        total = 0

        def compare(pos, k, v):
            nonlocal bad, total
            bad = bad + (k != kp[pos]).sum() + (v != vp[pos]).sum()
            total += k.numel() + v.numel()

        if li == 0:
            x0 = embed(np.concatenate([seq.prompt[:last], dec_in]))
            _, k, v = _qkv(x0, torch.arange(last + n, device=dev), lw,
                           shp, prec)
            compare(torch.arange(last + n, device=dev), k, v)

        for i, (off, _) in enumerate(seq.calls):
            end = off + xs[i].shape[0]
            pos = torch.arange(off, end, device=dev)
            own = slice(0, max(0, min(end, last) - off))

            def prefill(q, k, v, off=off, end=end, pos=pos, own=own):
                if li:
                    compare(pos[own], k[own], v[own])
                kc = _pad0(kp[:last], end).clone()
                vc = _pad0(vp[:last], end).clone()
                lo = max(last, off)
                kc[lo:end], vc[lo:end] = k[lo - off:], v[lo - off:]
                return hdp_prefill(q, pos, kc, vc, end, hdp)

            xs[i] = _block(xs[i], pos, prefill, lw, shp, prec, False)

        def decode(q, k, v):
            if li:
                compare(pos_d, k, v)
            return hdp_decode(q, pos_d, kp, vp, hdp)

        xd = _block(xd, pos_d, decode, lw, shp, prec, True)
        out.append((int(bad), total))
        del lw
    wn = W["final_norm"]["w"].to(dev)
    head = prec.weight(W["embed"]["lm_head"].to(dev))
    return out, prec.mm(rms_norm(xd, wn), head).to(F32)
