"""Qwen2-1.5B [arXiv:2407.10671; hf]: 28L d=1536 12H (kv=2) d_ff=8960,
vocab 151936 — GQA with QKV bias."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        act="silu_glu",
        qkv_bias=True,
        tie_embeddings=True,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="QKV biases are quantized with the activations before the "
              "integer scout (they shift the integer parts).",
    )
