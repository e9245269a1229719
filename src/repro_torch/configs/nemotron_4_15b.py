"""Nemotron-4-15B [arXiv:2402.16819; unverified]: 32L d=6144 48H (kv=8)
d_ff=24576, vocab 256000 — GQA, squared-ReLU (non-gated) MLP."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def nemotron_4_15b() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=256_000,
        act="relu2",
        rope_theta=10_000.0,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
    )
