"""Port parity of the train step on reduced whisper-large-v3 (CPU): the
loss and every gradient against ``jax.value_and_grad`` of the
reference's, then three train steps at two microbatches against the
jitted reference step, on batches of the shapes ``registry.input_specs``
gives a train cell (frames [B, 64, d_model], tokens [B, 8]). The helpers
and tolerances are ``test_torch_train_families.py``'s (no extra
tolerance for whisper).

Through the launchers, whisper raises in both packages: they pass tokens
only, and whisper's train step reads frames (the reference's jitted
step rejects the batch's tree, the port's ``apply_train`` raises
KeyError; ROADMAP.md section 3).
"""
from __future__ import annotations

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train

from test_torch_train_families import check_family

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def test_whisper_loss_grads_and_steps_match_jax():
    check_family("whisper-large-v3", S=64)


def test_whisper_launcher_raises_like_jax():
    with pytest.raises(ValueError, match="pytree"):
        jtrain.run(jtrain.build_parser().parse_args(
            ["--arch", "whisper-large-v3", "--reduced", "--steps", "1"]))
    with pytest.raises(KeyError, match="frames"):
        train.run(train.build_parser().parse_args(
            ["--arch", "whisper-large-v3", "--reduced", "--steps", "1",
             "--device", "cpu"]))
