"""RWKV6-3B "Finch" [arXiv:2404.05892; hf]: 32L d=2560 attention-free,
d_ff=8960, vocab 65536 — data-dependent decay.

HDP does not apply (no attention score matrix exists); hdp=None.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def rwkv6_3b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="rwkv6",
        n_layers=32,
        d_model=2560,
        n_heads=40,            # d / ssm_head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        ssm_head_dim=64,
        norm="layernorm",
        pos_emb="none",
        hdp=None,
        notes="attention-free: no QK^T exists, HDP inapplicable.",
    )
