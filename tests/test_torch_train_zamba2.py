"""Port parity of the train step on reduced zamba2-7b (CPU): the loss and
every gradient against ``jax.value_and_grad`` of the reference's, then
three train steps at two microbatches against the jitted reference step
(S 24: the Mamba2 layers take the chunked SSD, the shared attention
block a trainable call). The helpers are
``test_torch_train_families.py``'s; zamba2's gradients, m and v are held
at an extra 2e-3 of each leaf's largest value, its grad norm at rtol
1e-3 and its params at the peak lr (one update), because a Mamba2 layer amplifies fp32 rounding ~10x on random
weights (ROADMAP.md section 3; measured: 6e-4 of the largest gradient in
the first group's conv and projections, 2.3e-4 in the grad norm).
"""
from __future__ import annotations

import torch

from test_torch_train_families import check_family

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def test_zamba2_loss_grads_and_steps_match_jax():
    check_family("zamba2-7b")
