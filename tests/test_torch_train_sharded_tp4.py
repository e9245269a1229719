"""The sharded train step in a gloo world of four ranks at (data 2,
model 2) (reduced configs, CPU).

One ``LocalWorld(4)`` for the module and one ``run``: every rank trains
reduced qwen2-1.5b (TP rules: heads, mlp and vocab over ``model``, the
optimizer state over ``data`` as well), then reduced olmoe-1b-7b under
the FSDP rules (``fsdp=True``: its 4 experts over ``data``, the embed
dims of the dense weights over ``data``, and the load-balancing loss's
expert shares averaged over the data-parallel group, as the reference's
are over the whole batch), each 3 steps of 2 microbatches from the same
seeded weights as the unsharded port step. Every rank's loss and grad
norm equal the unsharded step's, and its shards of params, m, v and
master equal the slices of that step's results, within ``PERF.md``
section 2's train-step limits (``test_torch_train_sharded.check_ranks``).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.launch.local_world import LocalWorld

from test_torch_train_sharded import check_ranks, train_rank, unsharded

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

MESH = (2, 2)


def _rank_both():
    return {"qwen": train_rank(MESH),
            "olmoe": train_rank(MESH, arch="olmoe-1b-7b", fsdp=True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with LocalWorld(4, tmp_path_factory.mktemp("train4_store")) as w:
        return w.run(_rank_both)


def test_data_and_model_axes_equal_unsharded(ranks):
    assert [r["qwen"]["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    check_ranks([r["qwen"] for r in ranks], unsharded(), MESH)


def test_fsdp_moe_experts_on_data_equal_unsharded(ranks):
    olmoe = [r["olmoe"] for r in ranks]
    specs = olmoe[0]["specs"]
    ffn = specs["params"]["layers"]["ffn"]
    assert tuple(ffn["w_gate"]) == (None, "data", None, "model")
    assert tuple(specs["params"]["layers"]["attn"]["wq"]) == \
        (None, "data", "model", None)
    assert olmoe[0]["params"]["layers"]["ffn"]["w_gate"].shape[1] == 2
    check_ranks(olmoe, unsharded("olmoe-1b-7b"), MESH)
