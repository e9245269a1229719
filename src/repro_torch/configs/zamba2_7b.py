"""Zamba2-7B [arXiv:2411.15242; unverified]: 81L d=3584 32H (kv=32)
d_ff=14336, vocab 32000, ssm_state=64 — Mamba2 backbone + shared attention
block (every 6 layers) with per-invocation LoRA.

HDP applies to the shared attention block only.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="zamba2",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        attn_every=6,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="Mamba2 blocks are attention-free (HDP n/a there); the shared "
              "attention block gets HDP.",
    )
