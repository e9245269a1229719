"""Granite-8B (code) [arXiv:2405.04324; hf]: 36L d=4096 32H (kv=8)
d_ff=14336, vocab 49152 — llama-arch."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def granite_8b() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        act="silu_glu",
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
    )
