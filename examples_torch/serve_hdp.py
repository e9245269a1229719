"""End-to-end serving example (the paper's use case is inference).

    PYTHONPATH=src:. python examples_torch/serve_hdp.py [--device cpu]

Trains (or loads the cached) small in-framework LM, then serves it with
**batched requests + continuous batching**, HDP active in prefill and
decode: on the card the paged decode reads the listed KV pages through
the FUM kernel (one launch per layer per decode step). Prints an A/B
against dense attention: throughput, achieved block/head sparsity, the
KV bytes a decode step reads at that sparsity, and generated-token
agreement.
"""
import argparse

import numpy as np

from examples_torch import common
from repro_torch.attention import AttnSpec
from repro_torch.core.config import HDPConfig
from repro_torch.launch.measure_profile import smi_line
from repro_torch.models.layers import resolve_device
from repro_torch.serving import Engine, Request
from repro_torch.serving.kv_cache import kv_read_bytes_per_step

ap = argparse.ArgumentParser()
ap.add_argument("--scale", default="tiny", choices=["tiny", "base"])
ap.add_argument("--requests", type=int, default=10)
ap.add_argument("--max-new", type=int, default=8)
ap.add_argument("--rho-b", type=float, default=-0.5)
ap.add_argument("--device", default="cuda")
ap.add_argument("--train-steps", type=int, default=300)
args = ap.parse_args()
dev = resolve_device(args.device)
card = smi_line() if dev.type == "cuda" else "CPU"

cfg, params = common.train_model(args.scale, steps=args.train_steps,
                                 device=dev)

# calib="none": the paged serving backend quantizes its scout copy at
# cache-write time, so the static grid is the regime it operates in
hdp = HDPConfig(rho_b=args.rho_b, block_q=2, block_k=2, causal=True,
                head_pruning=True, tau_h=0.0, normalize_head_score=True,
                calib="none")

rng = np.random.default_rng(0)
prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(6, 40)))
           .tolist() for _ in range(args.requests)]


def serve(with_hdp: bool, layout: str = "paged"):
    c = cfg.replace(hdp=hdp) if with_hdp else cfg
    eng = Engine(c, params=params, device=dev, max_batch=4, max_len=96,
                 prefill_buckets=(16, 32, 64), collect_stats=with_hdp,
                 attn=AttnSpec(layout=layout))
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=args.max_new))
    res = eng.run()
    return res, eng.summary()


res_hdp, s_hdp = serve(True)                      # paged + HDP (FUM gather)
res_dense, s_dense = serve(False, "dense")        # dense slots, no pruning

agree = np.mean([
    np.mean(np.asarray(res_hdp[u].tokens) == np.asarray(res_dense[u].tokens))
    for u in res_hdp])
dense_b, hdp_b = kv_read_bytes_per_step(
    cfg, 32768, 1, s_hdp["block_sparsity"])

print(f"\nserving bench-{args.scale} (trained in-framework), "
      f"{args.requests} requests x {args.max_new} new tokens on {card}")
print(f"  HDP  : {s_hdp.get('decode_tok_s', 0):7.1f} tok/s   "
      f"block sparsity {s_hdp['block_sparsity']:.2f}  "
      f"head sparsity {s_hdp['head_sparsity']:.2f}  "
      f"page sparsity {s_hdp['page_sparsity']:.2f}  "
      f"(decode: {s_hdp['attn_backend_decode']})")
print(f"  dense: {s_dense.get('decode_tok_s', 0):7.1f} tok/s")
print(f"  KV cache resident: paged {s_hdp['cache_bytes'] / 1e3:.1f} KB "
      f"(page size {s_hdp['page_size']}) vs dense slots "
      f"{s_dense['cache_bytes'] / 1e3:.1f} KB")
print(f"  generated-token agreement HDP vs dense: {agree:.3f}")
print(f"  FUM KV-read saving at this sparsity (32k ctx, per seq/step): "
      f"{dense_b / 1e6:.1f} MB -> {hdp_b / 1e6:.1f} MB "
      f"({1 - hdp_b / max(dense_b, 1):.0%} fewer KV bytes read per "
      f"decode step)")
