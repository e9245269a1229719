"""Whisper-large-v3 [arXiv:2212.04356; unverified]: 32L enc + 32L dec,
d=1280 20H (kv=20) d_ff=5120, vocab 51866 — enc-dec, conv frontend STUB
(precomputed frame embeddings stand in for the audio)."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def whisper_large_v3() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="whisper",
        n_layers=32,
        encoder_layers=32,
        decoder_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        pos_emb="sinusoidal",
        tie_embeddings=True,
        max_source_positions=1500,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="frontend stub per assignment; decoder positions sinusoidal "
              "(learned 448-entry table too small for assigned 32k decode).",
    )
