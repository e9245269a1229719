"""Port parity of serving from each pool format: the port's ``Engine`` on
the CPU (plain kernel versions) and the JAX ``Engine`` serve the same
prompts with the same weights from the paged pool with HDP on, in every
format and scale the reference allows — int8 and fp8_v on the static
grid and with absmax page scales, and the unquantized "fp32" pool with
its int8 scout copy — on reduced qwen2-1.5b and reduced granite-8b,
and must emit byte-identical greedy tokens with the same resolved
backends, pool bytes and sparsity (``test_torch_dense_layout.py``'s
``check_serving_parity``)."""
from __future__ import annotations

import pytest
import torch

from test_torch_dense_layout import check_serving_parity

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

POOLS = [dict(kv_dtype="int8", kv_scale="grid"),
         dict(kv_dtype="int8", kv_scale="absmax"),
         dict(kv_dtype="fp8_v", kv_scale="grid"),
         dict(kv_dtype="fp8_v", kv_scale="absmax"),
         dict(kv_dtype="fp32")]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-8b"])
@pytest.mark.parametrize("spec_kw", POOLS,
                         ids=["-".join(kw.values()) for kw in POOLS])
def test_pool_greedy_tokens_equal_jax_engine(arch, spec_kw):
    check_serving_parity(arch, True, spec_kw)
