"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L d=5120 40H (kv=8) d_ff=8192, vocab 202048, MoE 16e top-1 + shared
expert, early fusion."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=16,
        n_experts_active=1,
        n_shared_experts=1,
        act="silu_glu",
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="top-1 routing + always-on shared expert; early fusion means "
              "image tokens share the vocab (frontend out of scope).",
    )
