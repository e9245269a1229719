"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d=2048 16H (kv=16) d_ff=1024,
vocab 50304, MoE 64 experts top-8."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        n_experts=64,
        n_experts_active=8,
        act="silu_glu",
        qk_norm=True,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="MoE FFN untouched by HDP (attention-only technique).",
    )
