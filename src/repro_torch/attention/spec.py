"""Attention call descriptors and backend-selection specs.

PyTorch counterpart of ``repro.attention.spec`` (plain dataclasses, the
same fields and checks; ``policy="cost"`` ranks auto candidates through
``repro_torch.autotune``).

``AttnCall`` is the frozen, hashable descriptor of ONE attention
invocation — everything a backend needs to decide *whether* it can serve
the call (``Backend.supports``) and *how* (mask semantics, HDP pipeline
on/off, cache layout). Runtime tensors (position arrays, page tables,
page pools) are deliberately NOT part of the call: they are passed
alongside to :func:`repro_torch.attention.attention` so the descriptor stays
a hashable, static description of the call. The paper-level knobs named in the
design (q_offset / kv_len) are generalized here to the ``q_pos`` /
``k_pos`` position arrays every implementation already masks with.

``AttnSpec`` is the user-facing selection policy threaded through the
model / serving layers instead of the former stringly-typed
``attn_backend=`` / ``cache_backend=`` kwargs: an exact backend name, a
family tag ("xla" | "pallas" | "reference"), or "auto", with optional
per-mode overrides plus the serving cache layout. The old string kwargs
keep working for one release via :func:`spec_from_legacy`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.core.config import HDPConfig

MODES = ("prefill", "decode")
LAYOUTS = ("dense", "paged")
CACHE_LAYOUTS = ("auto", "dense", "paged")
DRAFT_SCORES = ("scout", "int", "approx")
POLICIES = ("auto", "static", "cost")
KV_DTYPES = ("auto", "fp32", "int8", "fp8_v")
KV_SCALES = ("grid", "absmax")

@dataclasses.dataclass(frozen=True)
class DraftProfile:
    """Approximate-attention overlay for the self-speculative draft pass.

    The draft runs the same transformer with a cheaper attention step and
    proposes tokens that a full-fidelity verify pass then accepts or
    rejects — so the profile only trades *acceptance rate* against *draft
    cost*, never output correctness (exact-match acceptance keeps the
    committed tokens identical to non-speculative greedy decode).

    Attributes:
      rho_b / tau_h: optional overrides of the HDP survival thresholds —
        a more aggressive grid than the exact pass (fewer blocks/heads
        survive, so the draft fetches less KV memory).
      scores: score source of the draft attention:
        * ``"scout"`` — ``QQ·IK + IQ·FK^`` over the two int8 scout
          copies of K (the integer copy the decode scout always streams,
          plus a write-time quantized-fraction copy): recovers the exact
          pass's approximate scores to within the 2^-6 fraction grid,
          and the full-precision K of the cache is never read by a
          draft step. The default — near-exact proposals at int8
          bandwidth.
        * ``"int"`` — the scout matmul itself (``IQ·IK``, integer parts
          only) reused as the score; the cheapest draft, no extra matmul.
        * ``"approx"`` — the exact pass's ``QQ·KQ - FQ·FK``; the draft
          is then a pruning-only approximation (thresholds overrides do
          all the work).
    """

    rho_b: Optional[float] = None
    tau_h: Optional[float] = None
    scores: str = "scout"

    def __post_init__(self):
        if self.scores not in DRAFT_SCORES:
            raise ValueError(
                f"draft scores must be one of {DRAFT_SCORES}, "
                f"got {self.scores!r}")
        if self.rho_b is not None and not (-1.0 < self.rho_b < 1.0):
            raise ValueError(f"draft rho_b must be in (-1, 1), got {self.rho_b}")

    def overlay(self, hdp: HDPConfig) -> HDPConfig:
        """HDP config the draft attends with (threshold overrides applied)."""
        kw = {}
        if self.rho_b is not None:
            kw["rho_b"] = self.rho_b
        if self.tau_h is not None:
            kw["tau_h"] = self.tau_h
        return hdp.replace(**kw) if kw else hdp


@dataclasses.dataclass(frozen=True)
class AttnCall:
    """Static descriptor of one attention invocation.

    Attributes:
      mode: "prefill" (train and prompt runs) | "decode" (query vs cache).
      layout: "dense" contiguous K/V tensors | "paged" block-paged pools
        (cache dict with ``k_pages``/``v_pages``[/``k_scout``] + table).
      causal: compose a causal mask from the q/k position arrays.
      window: sliding-window width (0 = unbounded).
      hdp: the HDP pipeline config, or None for exact dense attention
        (``enabled=False`` configs are normalized to None at build time).
      per_slot: positions carry a batch dim (continuous-batching decode).
      self_aligned: q spans the whole KV extent from position 0 with
        shared positions (no cache, no cross) — the shape contract the
        monolithic Pallas kernels require.
      trainable: gradients must flow (train step); excludes backends
        without a VJP (the Pallas kernels).
      chunk: KV chunk length hint for flash-style scanning (0 = whole
        extent); a perf knob, never a semantic one.
      needs_stats: backend should return populated AttnStats.
      draft: self-speculative draft overlay (``hdp`` already carries the
        overlaid thresholds; this selects the draft score source), or
        None for a full-fidelity call. Only meaningful with HDP active —
        without a scout there is no approximate path to draft with.
      kv_scale: scale grid of the quantized pool — "grid" (static
        power-of-two step) or "absmax" (per-page calibrated scales; the
        stage-3 dequant must then read the pool's scale arrays).
      verify: multi-query decode (Sq > 1 query rows over one cache, the
        speculative verify shape). HDP backends must then run the scout
        *per query row* — each row's keep mask / head gate must equal
        what its own single-token decode step would compute, or
        exact-match acceptance loses token identity. Verify rows sit at
        consecutive positions (row j's KV extent is row 0's plus j).
    """

    mode: str
    layout: str = "dense"
    causal: bool = True
    window: int = 0
    hdp: Optional[HDPConfig] = None
    per_slot: bool = False
    self_aligned: bool = False
    trainable: bool = False
    chunk: int = 0
    needs_stats: bool = False
    draft: Optional[DraftProfile] = None
    verify: bool = False
    kv_scale: str = "grid"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.kv_scale not in KV_SCALES:
            raise ValueError(
                f"kv_scale must be one of {KV_SCALES}, got {self.kv_scale!r}")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"layout must be one of {LAYOUTS}, got {self.layout!r}")
        if self.layout == "paged" and self.mode != "decode":
            raise ValueError("paged layout is a decode-time serving format")
        if (self.draft is not None or self.verify) and self.mode != "decode":
            raise ValueError("draft/verify are decode-time call shapes")
        if self.hdp is not None and not self.hdp.enabled:
            object.__setattr__(self, "hdp", None)
        if self.hdp is None:
            # no scout => nothing to approximate; a draft call degenerates
            # to the exact attention step (still a valid token proposer)
            object.__setattr__(self, "draft", None)

    def replace(self, **kw) -> "AttnCall":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Backend-selection policy threaded through models / serving.

    Attributes:
      backend: exact backend name (``"xla_hdp"``), family tag (``"xla"``,
        ``"pallas"``, ``"reference"``), or ``"auto"`` (highest-ranked
        supporting backend; Pallas ranks above XLA only on TPU).
      prefill / decode: optional per-mode overrides of ``backend``.
      layout: serving cache layout — "auto" picks paged for transformer
        families, dense otherwise (Engine-level; ignored by dispatch).
      kv_dtype: storage format of the paged KV pool — "int8" (the
        production default: per-page scales, scout copies derived as
        views), "fp8_v" (int8 K + fp8 V), or "fp32" (the opt-in A/B
        oracle). "auto" (default) resolves through ``REPRO_KV_DTYPE``
        then "int8". Quantized-pool engines round-trip K/V through the
        pool grid at *prefill* write time (so prefix hits, COW tails and
        chunked prefill stay token-identical to cold runs); dense-layout
        engines always serve fp32.
      kv_scale: scale calibration of the quantized pool — "grid" (the
        default static power-of-two step; bit-parity guarantees hold) or
        "absmax" (opt-in per-page calibrated absmax scales: lower
        round-trip error, but prefill values are no longer snapped to a
        known grid, so hot/cold bit parity is forfeited and the fp32
        A/B drift gate is the accuracy contract instead).
      allow_fallback: when the requested backend does not support a call,
        fall down the auto chain instead of raising.
      policy: how "auto" picks among supporting candidates —
        * ``"static"``: registry priority order (the historical rule).
        * ``"cost"``: the :mod:`repro_torch.autotune` cost model ranks
          the candidates under the device's hardware profile, probing
          ambiguous calls once. Only consulted when the *requested*
          backend resolves to "auto" — an exact name or family tag still
          pins.
        * ``"auto"`` (default): ``REPRO_ATTN_POLICY`` decides (``cost``
          enables the tuner, anything else means static).
    """

    backend: str = "auto"
    prefill: Optional[str] = None
    decode: Optional[str] = None
    layout: str = "auto"
    kv_dtype: str = "auto"
    kv_scale: str = "grid"
    allow_fallback: bool = True
    policy: str = "auto"

    def __post_init__(self):
        if self.layout not in CACHE_LAYOUTS:
            raise ValueError(
                f"layout must be one of {CACHE_LAYOUTS}, got {self.layout!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {self.kv_dtype!r}")
        if self.kv_scale not in KV_SCALES:
            raise ValueError(
                f"kv_scale must be one of {KV_SCALES}, got {self.kv_scale!r}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {self.policy!r}")

    def requested_for(self, mode: str) -> str:
        over = self.prefill if mode == "prefill" else self.decode
        return over if over is not None else self.backend

    def replace(self, **kw) -> "AttnSpec":
        return dataclasses.replace(self, **kw)


_LEGACY_ATTN = {"xla": "xla", "pallas": "pallas", "auto": "auto"}


def spec_from_legacy(attn_backend: Optional[str] = None,
                     cache_backend: Optional[str] = None,
                     base: Optional[AttnSpec] = None,
                     stacklevel: int = 3) -> AttnSpec:
    """Map the deprecated string kwargs onto an :class:`AttnSpec`.

    Emits ONE DeprecationWarning covering every legacy kwarg passed.
    Removal is scheduled for the release after the registry lands.
    """
    spec = base if base is not None else AttnSpec()
    legacy = []
    if attn_backend is not None:
        if attn_backend not in _LEGACY_ATTN:
            raise ValueError(f"unknown attn_backend {attn_backend!r}")
        legacy.append(f"attn_backend={attn_backend!r}")
        spec = spec.replace(backend=_LEGACY_ATTN[attn_backend])
    if cache_backend is not None:
        if cache_backend not in CACHE_LAYOUTS:
            raise ValueError(f"unknown cache_backend {cache_backend!r}")
        legacy.append(f"cache_backend={cache_backend!r}")
        spec = spec.replace(layout=cache_backend)
    if legacy:
        warnings.warn(
            f"{', '.join(legacy)} string kwargs are deprecated; pass "
            f"attn=AttnSpec(backend={spec.backend!r}, layout={spec.layout!r}) "
            "instead (repro_torch.attention.AttnSpec)",
            DeprecationWarning, stacklevel=stacklevel)
    return spec
