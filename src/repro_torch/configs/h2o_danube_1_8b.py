"""H2O-Danube-1.8B [arXiv:2401.16818; hf]: 24L d=2560 32H (kv=8)
d_ff=6912, vocab 32000 — llama+mistral mix with sliding-window attention."""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.core.config import HDPConfig


@register
def h2o_danube() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        act="silu_glu",
        sliding_window=4096,
        hdp=HDPConfig(block_q=128, block_k=128, rho_b=0.5, tau_h=0.0,
                      normalize_head_score=True, causal=True),
        notes="SWA makes this arch sub-quadratic: long_500k runs with a "
              "ring-buffered window cache; HDP mask composes with the band.",
    )
