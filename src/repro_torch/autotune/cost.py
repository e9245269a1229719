"""Analytic bytes/FLOPs/step-time predictor per attention backend.

PyTorch counterpart of ``repro.autotune.cost``, line for line: the same
``OP_WEIGHT`` constants, the same terms, the same float arithmetic in
the same order, so a prediction under ``HOST_CPU`` equals the
reference's bit for bit.

One :class:`CallSig` captures the static *shape* of an attention
invocation — what :class:`repro_torch.attention.AttnCall` deliberately
omits so it stays a pure capability descriptor: batch, head geometry,
query span, KV extent, page geometry and dtypes. :func:`call_signature`
builds it from the live torch tensors of a dispatch, and it is the
tuner's cache key (``key()`` strings equal the reference's).

:func:`predict` maps ``(backend name, CallSig, HardwareProfile,
SparsityEstimate)`` to a :class:`CostEstimate` — HBM bytes + FLOPs for
the attention call, plus a per-backend fixed overhead term modelling the
extra ops a multi-stage sparse pipeline dispatches. Step time is the
roofline max of the compute and memory terms plus the overhead; the
kernel backends (the reference's Pallas names) on a profile that does
not run them natively (the CPU, where they run their plain versions)
are scaled by the profile's slowdown, so cost selection never picks
them there.

The formulas model what the backends stream:

* ``xla_dense`` — Q/O traffic + the full K/V extent once, dense QK/PV.
* ``xla_hdp`` — dense layout: the scout is (re)quantized from full K per
  call and every byte is streamed regardless of the masks (pruning only
  saves *compute* there), so HDP costs MORE than dense at equal shapes.
* ``paged_hdp_decode`` / ``pallas_*`` paged — int8 scout bytes over the
  resident extent + only the *surviving* fraction of full-precision
  K/V (fetch-upon-mask); draft calls with scout scores never read
  full K at all. This is the term the measured page-sparsity counters
  sharpen: benefit grows with ``sparsity x kv_len``, overhead does not.
* ``reference`` — the densifying oracle: materializes gathered K/V and
  [Sq, Sk] masks; priced accordingly so it is never cost-picked.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline.hardware import HardwareProfile

#: per-backend fused-op weight (the reference's constants): roughly how
#: many extra kernel launches / fusion barriers the implementation costs
#: beyond one dense matmul pair.
#: Multiplies ``HardwareProfile.op_overhead_s`` — the constant term that
#: makes sparse pipelines lose below the sparsity x kv_len crossover.
OP_WEIGHT = {
    "xla_dense": 2.0,
    "xla_hdp": 8.0,
    "paged_hdp_decode": 14.0,
    "pallas_flash": 1.0,
    "pallas_hdp_block": 6.0,
    "pallas_paged_decode": 4.0,
    "reference": 24.0,
}

_PALLAS = ("pallas_flash", "pallas_hdp_block", "pallas_paged_decode")


@dataclasses.dataclass(frozen=True)
class CallSig:
    """Static shape signature of one attention invocation (hashable)."""

    mode: str               # "prefill" | "decode"
    layout: str             # "dense" | "paged"
    batch: int
    n_kv_heads: int
    group: int              # query heads per KV head (GQA)
    sq: int                 # query span (verify calls: draft_len)
    hd: int
    kv_len: int             # visible KV extent (paged: pages_per_slot*ps)
    page_size: int = 0      # 0 for dense layout
    q_itemsize: int = 4
    kv_itemsize: int = 4
    hdp: bool = False
    block_q: int = 0
    block_k: int = 0
    draft: str = ""         # DraftProfile.scores, "" = full-fidelity
    verify: bool = False
    causal: bool = True
    window: int = 0
    per_slot: bool = False
    tp: int = 1             # tensor-parallel degree (shapes are per-shard)

    @property
    def heads(self) -> int:
        return self.n_kv_heads * self.group

    def key(self) -> str:
        """Serializable tuner-cache key (stable across processes)."""
        return (f"{self.mode}:{self.layout}:b{self.batch}:n{self.n_kv_heads}"
                f"xg{self.group}:sq{self.sq}:hd{self.hd}:kv{self.kv_len}"
                f":ps{self.page_size}:dt{self.q_itemsize}.{self.kv_itemsize}"
                f":hdp{int(self.hdp)}:bq{self.block_q}:bk{self.block_k}"
                f":dr{self.draft or '-'}:v{int(self.verify)}"
                f":c{int(self.causal)}:w{self.window}:s{int(self.per_slot)}"
                f":tp{self.tp}")


def call_signature(call, q, k=None, cache=None, page_table=None,
                   tp: int = 1) -> CallSig:
    """Build the CallSig of a live dispatch from its tensors' shapes and
    ``dtype.itemsize``.

    ``q`` is the [B,N,G,Sq,hd] query; paged calls derive the KV extent
    from the page pool + table, dense calls from ``k``. ``tp`` is the
    tensor-parallel degree (``distribution.tp.active_tp``; ``q`` and the
    pool are then one rank's heads): it keys the signature so probe
    caches never mix mesh shapes, and prices the output all-gather.
    """
    B, N, G, Sq, hd = q.shape
    if call.layout == "paged":
        ps = cache["k_pages"].shape[1]
        kv = page_table.shape[1] * ps
        kv_item = cache["k_pages"].dtype.itemsize
    else:
        ps = 0
        kv = k.shape[1] if k is not None else Sq
        kv_item = k.dtype.itemsize if k is not None else q.dtype.itemsize
    hdp = call.hdp
    return CallSig(
        mode=call.mode, layout=call.layout, batch=B, n_kv_heads=N, group=G,
        sq=Sq, hd=hd, kv_len=kv, page_size=ps,
        q_itemsize=q.dtype.itemsize, kv_itemsize=kv_item,
        hdp=hdp is not None,
        block_q=hdp.block_q if hdp is not None else 0,
        block_k=hdp.block_k if hdp is not None else 0,
        draft=call.draft.scores if call.draft is not None else "",
        verify=call.verify, causal=call.causal, window=call.window,
        per_slot=call.per_slot, tp=max(int(tp), 1))


@dataclasses.dataclass(frozen=True)
class SparsityEstimate:
    """Surviving-work fractions the predictor scales sparse terms by.

    Fed from the engine's measured AttnStats means (block / head / page
    sparsity EMAs); the prior before any measurement is derived from the
    HDP thresholds — deliberately conservative (rho_b only suggests, the
    data decides), so unmeasured predictions under-promise HDP.
    """

    block: float = 0.0
    head: float = 0.0
    page: float = 0.0

    @classmethod
    def prior(cls, sig: CallSig) -> "SparsityEstimate":
        if not sig.hdp:
            return cls()
        # a positive survival threshold prunes roughly the mass below it;
        # claim half of that until the counters say otherwise
        return cls(block=0.25, head=0.0, page=0.25)

    def clamped(self) -> "SparsityEstimate":
        f = lambda x: min(max(float(x), 0.0), 0.999)  # noqa: E731
        return SparsityEstimate(f(self.block), f(self.head), f(self.page))


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Attention-call cost: roofline terms + fixed pipeline overhead."""

    flops: float
    hbm_bytes: float
    overhead_s: float
    interpreted: bool = False

    def step_time(self, hw: HardwareProfile) -> float:
        t = (max(self.flops / hw.peak_flops, self.hbm_bytes / hw.hbm_bw)
             + self.overhead_s)
        return t * hw.interpret_slowdown if self.interpreted else t


def predict(backend: str, sig: CallSig, hw: HardwareProfile,
            sparsity: Optional[SparsityEstimate] = None) -> CostEstimate:
    """CostEstimate of ``backend`` serving one call shaped ``sig``."""
    sp = (sparsity if sparsity is not None
          else SparsityEstimate.prior(sig)).clamped()
    B, H, N = sig.batch, sig.heads, sig.n_kv_heads
    Sq, kv, hd = sig.sq, sig.kv_len, sig.hd
    if sig.causal and sig.mode == "prefill" and Sq == kv:
        kv_eff = max(kv / 2.0, 1.0)      # triangular extent actually scored
    else:
        kv_eff = float(kv)

    q_io = 2.0 * B * H * Sq * hd * sig.q_itemsize        # read Q + write O
    kv_full = 2.0 * B * kv * N * hd * sig.kv_itemsize    # K + V, whole extent
    scout_io = 1.0 * B * kv * N * hd                     # int8 scout copy
    dot = 4.0 * B * H * Sq * kv_eff * hd                 # QK^T + PV
    softmax = 8.0 * B * H * Sq * kv_eff

    surv_b = 1.0 - max(sp.block, sp.page)   # surviving KV fraction
    surv_h = 1.0 - sp.head                  # surviving head fraction
    ov = hw.op_overhead_s * OP_WEIGHT.get(backend, 8.0)

    if backend == "xla_dense":
        f, by = dot + softmax, q_io + kv_full
    elif backend in ("xla_hdp", "pallas_hdp_block") and sig.layout == "dense":
        # dense HDP: full K/V streamed regardless of masks, K read twice
        # (quantize pass + attention); scout matmul on top of the dense
        # pair — pruning saves compute only, never bytes
        f = (dot + softmax) * surv_b * surv_h + 2.0 * B * H * Sq * kv_eff * hd
        by = q_io + kv_full * 1.5
    elif backend in ("paged_hdp_decode", "pallas_hdp_block",
                     "pallas_paged_decode"):
        # fetch-upon-mask: scout streamed over the resident extent, full
        # K/V only for surviving pages/blocks of surviving heads
        f = (2.0 * B * H * Sq * kv_eff * hd            # int scout scoring
             + (dot + softmax) * surv_b * surv_h)
        scout = scout_io * (2.0 if sig.draft == "scout" else 1.0)
        if sig.draft in ("scout", "int"):
            # draft steps never touch full-precision K; V of surviving
            # pages is still gathered for the weighted sum
            by = q_io + scout + surv_b * kv_full / 2.0
        else:
            by = q_io + scout + surv_b * kv_full * surv_h
    elif backend == "pallas_flash":
        f, by = dot + softmax, q_io + kv_full
    elif backend == "reference":
        # materializing oracle: densified gather + [Sq, Sk] score/mask
        # tensors as real arrays, everything re-read per stage
        f = 3.0 * dot + 4.0 * softmax
        by = q_io + 4.0 * kv_full + 4.0 * B * H * Sq * kv * sig.q_itemsize
    else:
        # unknown backend: dense-equivalent with a hefty uncertainty tax
        f, by, ov = dot + softmax, q_io + kv_full, ov * 4.0

    if sig.tp > 1:
        # tensor-parallel serving: each shard all-gathers the other
        # shards' per-head output slices before the o-projection. The
        # sig's shapes are per-shard, so H is the LOCAL head count; the
        # gathered traffic is the (tp-1) remote slices of the global
        # [B, H*tp, Sq, hd] output
        by = by + 2.0 * B * (H * sig.tp) * Sq * hd * sig.q_itemsize \
            * (sig.tp - 1) / sig.tp

    return CostEstimate(flops=f, hbm_bytes=by, overhead_s=ov,
                        interpreted=(backend in _PALLAS
                                     and not hw.pallas_native))


def predict_engine_step(n_active_params: int, batch: int, n_layers: int,
                        attn_est: CostEstimate, hw: HardwareProfile,
                        param_itemsize: int = 4) -> float:
    """Predicted wall time of one fused decode step of a whole model.

    Model term: 2*N_active FLOPs per token vs one full weight read
    (single-token decode is weight-bandwidth-bound); attention term: the
    per-layer call estimate times the layer count, plus one dispatch.
    ``param_itemsize`` stays the reference's 4, also for bf16 weights
    (ROADMAP.md section 3).
    """
    model_t = max(2.0 * n_active_params * batch / hw.peak_flops,
                  n_active_params * param_itemsize / hw.hbm_bw)
    return model_t + n_layers * attn_est.step_time(hw) + hw.dispatch_s


def crossover_table(sig: CallSig, hw: HardwareProfile, kv_lens,
                    page_sparsities) -> list:
    """kv_len x sparsity grid: predicted paged-HDP vs dense step time.

    The motivating tradeoff of the whole subsystem in one table — where
    ``sparsity x kv_len`` beats the sparse pipeline's overhead. The HDP
    side is priced at the *pool's* ``sig.kv_itemsize`` (1 under the
    production int8 store: surviving pages stream codes, dequant never
    round-trips HBM — a ~4x resident-extent byte drop that moves the
    crossover toward HDP at much shorter kv_len x sparsity products),
    while the dense comparator always streams the fp32 request cache.
    Returned rows carry both predicted times, the priced pool itemsize
    and the winner.
    """
    rows = []
    for kv in kv_lens:
        for psp in page_sparsities:
            s_hdp = dataclasses.replace(sig, kv_len=int(kv), hdp=True)
            s_dense = dataclasses.replace(sig, kv_len=int(kv), hdp=False,
                                          layout="dense", page_size=0,
                                          kv_itemsize=4)
            t_hdp = predict("paged_hdp_decode", s_hdp, hw,
                            SparsityEstimate(page=psp)).step_time(hw)
            t_dense = predict("xla_dense", s_dense, hw).step_time(hw)
            rows.append({"kv_len": int(kv), "page_sparsity": round(psp, 3),
                         "kv_itemsize": sig.kv_itemsize,
                         "t_hdp_s": t_hdp, "t_dense_s": t_dense,
                         "winner": "hdp" if t_hdp < t_dense else "dense"})
    return rows
