"""Chameleon-34B [arXiv:2405.09818; unverified]: 48L d=8192 64H (kv=8)
d_ff=22016, vocab 65536 — early-fusion VQ image tokens, qk-norm."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def chameleon_34b() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        act="silu_glu",
        qk_norm=True,  # chameleon's training-stability fix
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="VQ image tokens live in the vocab; frontend is the VQ "
              "tokenizer (stub — token ids arrive pre-quantized). qk-norm "
              "runs before HDP quantization.",
    )
