"""Model configuration: ``ModelConfig``, the registry and ``reduced``,
and the cell shapes ``ShapeConfig``/``SHAPES`` with ``cell_applicable``.

A field-for-field copy of ``repro.configs.base.ModelConfig`` (the port
keeps its own copy so that it imports nothing of the JAX package). The
port serves the architectures registered here through
``get_config(name)``; the launcher selects them with ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.config import HDPConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (see configs/<id>.py)."""

    name: str
    family: str                    # dense | moe | rwkv6 | zamba2 | whisper
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # transformer variants
    act: str = "silu_glu"          # silu_glu | gelu | relu2
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_emb: str = "rope"          # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    sliding_window: int = 0        # 0 = full attention
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group: int = 2048

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0

    # whisper / enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_positions: int = 0

    # HDP (None -> plain attention)
    hdp: Optional[HDPConfig] = None

    # numerics / implementation
    dtype: str = "bfloat16"        # activation/param storage dtype
    attn_impl: str = "jnp"         # kept for field parity with the reference
    attn_chunk: int = 1024
    remat: bool = True

    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "whisper"

    @property
    def sub_quadratic(self) -> bool:
        """Sub-quadratic sequence mixing (recurrent state or a window)."""
        return self.family in ("rwkv6", "zamba2") or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models import registry  # lazy; avoids a cycle
        return registry.param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    _ensure_imported()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> Tuple[str, ...]:
    """The registered architecture names, sorted."""
    _ensure_imported()
    return tuple(sorted(_REGISTRY))


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) runnable? Returns (ok, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: long_500k requires sub-quadratic "
                       "sequence mixing (DESIGN.md §Arch-applicability)")
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (same rule as the
    reference's ``reduced``)."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        remat=False,
        attn_chunk=32,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, n_experts_active=min(cfg.n_experts_active, 2),
                  capacity_factor=4.0)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.family in ("rwkv6", "zamba2"):
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=5)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, decoder_layers=2, max_source_positions=64)
    if cfg.hdp is not None:
        kw.update(hdp=cfg.hdp.replace(block_q=2, block_k=2))
    return cfg.replace(**kw)


def _ensure_imported() -> None:
    import repro_torch.configs  # noqa: F401  (side-effect registry)
