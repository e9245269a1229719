"""Sweep HDP's pruning knobs on a trained model and print the frontier.

    PYTHONPATH=src:. python examples_torch/pruning_sweep.py [--device cpu]

Trains (or loads the cached) small in-framework LM, then sweeps
(rho_B, tau_H) and prints net sparsity vs top-1 agreement — the Fig. 10
trade-off curve users tune in deployment. Template code.
"""
import argparse

import numpy as np

from examples_torch import common
from repro_torch.core.config import HDPConfig
from repro_torch.core.hdp import hdp_attention
from repro_torch.launch.measure_profile import smi_line
from repro_torch.models.layers import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--train-steps", type=int, default=300)
args = ap.parse_args()
if resolve_device(args.device).type == "cuda":
    # the card that the training time below was taken on
    print(smi_line(), flush=True)

cfg, params = common.train_model("tiny", steps=args.train_steps,
                                 device=args.device)
batches = common.eval_batches(1)

base = HDPConfig(block_q=2, block_k=2, approx=True, causal=True,
                 head_pruning=True, tau_h=-1.0)
th = common.theta_head_samples(cfg, params, batches,
                               base.replace(block_pruning=False))

print(f"{'rho_b':>6} {'tau_pct':>8} {'net_sparsity':>13} {'agreement':>10}")
for rho in (-0.5, 0.01, 0.3, 0.6):
    for pct in (0, 15):
        tau = float(np.percentile(th, pct)) if pct else -1.0
        hdp = base.replace(rho_b=rho, tau_h=tau)

        def attn(li, q, k, v, _hdp=hdp):
            return hdp_attention(q, k, v, _hdp)[0]

        ag = common.agreement_with(cfg, params, attn, batches)
        caps = common.capture_qkv(cfg, params, batches[0])
        nets = [float(hdp_attention(c["q"], c["k"], c["v"], hdp)[1]
                      .net_sparsity) for c in caps]
        print(f"{rho:6.2f} {pct:8d} {np.mean(nets):13.3f} {ag:10.3f}")
print("\npick the sparsest point that meets your fidelity budget.")
