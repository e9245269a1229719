"""Port parity of serving zamba2-7b on its reduced config (fp32, CPU):
the reference's ``test_batched_equals_solo`` (HDP off, as in
``tests/test_serving.py``) at decode horizons 1 and 4, the port's
tokens equal to the JAX engine's, and ``summary()``'s layout and
resolved backends equal the JAX engine's (with HDP on, the shared
attention block resolves xla_hdp for prefill and decode in both). The
helpers and the shared tests are ``test_torch_recurrent_serving.py``'s;
this file holds zamba2's JAX engine (about 20 s of compiles) on its own.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_recurrent_serving import (_batched_equals_solo,
                                          _summary_equals_jax)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("horizon", [1, 4])
def test_batched_equals_solo(horizon):
    _batched_equals_solo("zamba2-7b", horizon)


def test_summary_layout_and_backends_equal_jax():
    _summary_equals_jax("zamba2-7b")
