"""Port parity of the train step on the windowed and MoE families (CPU).

Reduced h2o-danube-1.8b (its 16-token window takes ``local_attention``
at S 24) and olmoe-1b-7b (the aux loss, capacity factor 4.0): the loss
and every gradient against ``jax.value_and_grad`` of the reference's,
and three train steps at two microbatches against the jitted reference
step, with the helpers and tolerances of ``test_torch_train_step.py``
(atol 1e-5 / rtol 1e-4; params and master at 0.1 x the peak lr).
"""
from __future__ import annotations

import pytest
import torch

from test_torch_train_step import S, _model, _tokens, check_grads, check_steps

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_family_loss_grads_and_steps_match_jax(arch):
    cfg, jcfg, tree_np = _model(arch)
    if arch == "h2o-danube-1.8b":
        assert S > cfg.sliding_window     # the block-local window path
    else:
        assert cfg.n_experts and cfg.capacity_factor == 4.0
    check_grads(cfg, jcfg, tree_np, _tokens(1, 4))
    check_steps(cfg, jcfg, tree_np, nm=2)
