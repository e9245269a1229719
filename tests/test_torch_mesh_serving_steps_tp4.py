"""The prefill and decode steps on a mesh, and the dry run's collective
count, in a gloo world of four ranks at (data 2, model 2) (reduced
configs, CPU).

One ``LocalWorld(4)`` for the module and one ``run`` of
``test_torch_mesh_serving_steps.serve_rank``: each rank's prefill and
decode outputs and cache shards equal the one-device steps' rows and
slices bit for bit for reduced qwen2-1.5b, olmoe-1b-7b and zamba2-7b,
and reduced qwen2-1.5b's prefill, decode and train steps send, byte for
byte by kind, what the dry run records tracing them for the same rank.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.launch.local_world import LocalWorld

from test_torch_mesh_serving_steps import check_counts, check_equal, serve_rank

torch.set_num_threads(1)

MESH = (2, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with LocalWorld(4, tmp_path_factory.mktemp("mesh4_store")) as w:
        return w.run(serve_rank, MESH[1])


def test_mesh_prefill_decode_equal_one_device_rows(ranks):
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    check_equal(ranks, MESH)


def test_traced_collectives_equal_what_the_steps_send(ranks):
    check_counts(ranks, MESH)
