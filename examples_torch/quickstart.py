"""Quickstart: HDP attention as a drop-in PyTorch module.

    PYTHONPATH=src:. python examples_torch/quickstart.py [--device cpu]

Shows the three public entry points at increasing integration depth:
 1. `core.hdp.hdp_attention`       — one attention call with HDP
 2. `ModelConfig(hdp=...)`          — any of the 10 architectures with HDP
 3. `kernels.ops.hdp_attention_tpu` — the kernel pipeline: on the card the
    integer scout's and the block-sparse FUM attention's CUDA kernels; on
    the CPU (``--device cpu``) their plain PyTorch versions.

The inputs are drawn on the CPU from seeded ``torch.Generator``s, so a
run on the card and one on the CPU see the same values.
"""
import argparse

import torch

from repro_torch.common import tree
from repro_torch.configs import get_config, reduced
from repro_torch.core.config import PAPER_ASIC, TPU_KERNEL
from repro_torch.core.hdp import dense_attention_reference, hdp_attention
from repro_torch.kernels import ops
from repro_torch.kernels.hdp_block_attn import block_path
from repro_torch.kernels.hdp_scout import scout_path
from repro_torch.models import layers as L
from repro_torch.models import registry

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = L.resolve_device(args.device)


def randn(seed, shape, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


# ---------------------------------------------------------------- 1. core
print("== 1. one attention call ==")
B, H, S, hd = 2, 4, 128, 64
q = randn(0, (B, H, S, hd), 1.5)
k = randn(1, (B, H, S, hd), 1.5)
v = randn(2, (B, H, S, hd))

# rho_b < 0 uses the min-branch of Alg. 2 line 15 (gentler pruning —
# random gaussian q/k have flat attention, so the mean-branch would prune
# hard; trained models tolerate far more, see pruning_sweep.py)
cfg = PAPER_ASIC.replace(rho_b=-0.5, causal=True)     # 2x2 blocks, Alg. 2
out, stats = hdp_attention(q, k, v, cfg)
ref = dense_attention_reference(q, k, v, causal=True)
cos = float((out * ref).sum() / (out.norm() * ref.norm()))
print(f"block sparsity {float(stats.block_sparsity):.2f}  "
      f"head sparsity {float(stats.head_sparsity):.2f}  "
      f"net {float(stats.net_sparsity):.2f}  cosine vs dense {cos:.4f}")

# -------------------------------------------------------------- 2. models
print(f"\n== 2. architecture with HDP (reduced qwen2 on {dev.type}) ==")
mcfg = reduced(get_config("qwen2-1.5b"))
params = registry.init_params(mcfg, seed=1, device=dev)
tokens = torch.randint(0, mcfg.vocab_size, (2, 64),
                       generator=torch.Generator().manual_seed(2)).to(dev)
cache = registry.init_cache(mcfg, 2, max_len=96, device=dev)
logits, cache, _ = registry.apply_prefill(mcfg, params, {"tokens": tokens},
                                          cache)
print(f"prefill logits {tuple(logits.shape)}, cache leaves "
      f"{len(tree.leaves(cache))}; hdp enabled: {mcfg.hdp.enabled}")
tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
logits2, cache, _ = registry.apply_decode(
    mcfg, params, tok, cache, torch.full((2, 1), 64, device=dev))
print(f"decode step logits {tuple(logits2.shape)}")

# ------------------------------------------------------------- 3. kernels
kcfg = TPU_KERNEL.replace(block_q=64, block_k=64, rho_b=0.4)
if dev.type == "cuda":
    where = (f"CUDA kernels: scout on its "
             f"{scout_path(hd, kcfg.block_q, kcfg.block_k)} path, block "
             f"attention on its "
             f"{block_path(v.dtype, hd, kcfg.block_q, kcfg.block_k)} path")
else:
    where = "the kernels' plain PyTorch versions on the CPU"
print(f"\n== 3. HDP kernel pipeline ({where}) ==")
out_k, st = ops.hdp_attention_tpu(q, k, v, kcfg, return_stats=True)
ref_k, _ = hdp_attention(q, k, v, kcfg)
err = float((out_k - ref_k).abs().max())
print(f"kernel vs core-reference max err {err:.2e}  "
      f"block sparsity {float(st['block_sparsity']):.2f}  "
      f"kept blocks/row {float(st['kept_blocks_per_row']):.1f}")
print("\nquickstart OK")
