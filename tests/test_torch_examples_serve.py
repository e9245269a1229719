"""``examples_torch/serve_hdp.py`` against the JAX ``Engine``.

The script runs in this process (``runpy``, ``--device cpu``, 3
requests x 2 new tokens) with ``common.train_model`` returning
``bench-tiny``'s JAX initial weights (``PRNGKey(7)``) moved across with
``params_from_jax``. The JAX engine serves the same prompts with the
same weights and ``HDPConfig``, the HDP serve on the paged int8 pool and
the HDP-off serve on dense slots, pinned to the XLA backends, per-token
decode and no prefix cache, speculation or stream scheduler (so no
environment leg of the reference's CI changes what it serves). Both
serves' tokens must be equal, block, head and page sparsity within
1e-6, and ``kv_read_bytes_per_step`` at that sparsity equal.
"""
from __future__ import annotations

import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from examples_torch import common  # noqa: E402
from repro.attention import AttnSpec  # noqa: E402
from repro.core.config import HDPConfig  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import Engine, Request  # noqa: E402
from repro.serving.kv_cache import kv_read_bytes_per_step  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

REQUESTS, MAX_NEW = 3, 2
SPARSITY_TOL = 1e-6


def _jax_serve(cfg, params, prompts, with_hdp, layout):
    """The reference script's ``serve``, on the pinned spec."""
    hdp = HDPConfig(rho_b=-0.5, block_q=2, block_k=2, causal=True,
                    head_pruning=True, tau_h=0.0, normalize_head_score=True,
                    calib="none")
    c = cfg.replace(hdp=hdp) if with_hdp else cfg
    eng = Engine(c, params=params, max_batch=4, max_len=96,
                 prefill_buckets=(16, 32, 64), collect_stats=with_hdp,
                 attn=AttnSpec(layout=layout, backend="xla",
                               kv_dtype="int8"),
                 decode_horizon=1, prefix_cache=False, spec_decode=False,
                 stream_sched=False)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=MAX_NEW))
    return {u: r.tokens for u, r in eng.run().items()}, eng.summary()


@pytest.fixture(scope="module")
def served():
    jcfg = jcommon.model_cfg("tiny")
    jparams, _ = jregistry.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = common.model_cfg("tiny")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(common, "train_model",
               lambda scale, steps, device: (cfg, params))
    mp.setattr(sys, "argv", ["serve_hdp.py", "--device", "cpu",
                             "--requests", str(REQUESTS),
                             "--max-new", str(MAX_NEW)])
    try:
        g = runpy.run_path(str(ROOT / "examples_torch" / "serve_hdp.py"),
                           run_name="__main__")
    finally:
        mp.undo()
    prompts = g["prompts"]
    jax_runs = {
        "hdp": _jax_serve(jcfg, jparams, prompts, True, "paged"),
        "dense": _jax_serve(jcfg, jparams, prompts, False, "dense")}
    return g, jcfg, jax_runs


def test_prompts_are_the_reference_scripts(served):
    g, _, _ = served
    rng = np.random.default_rng(0)
    want = [rng.integers(1, common.VOCAB, size=int(rng.integers(6, 40)))
            .tolist() for _ in range(REQUESTS)]
    assert g["prompts"] == want


@pytest.mark.parametrize("run", ["hdp", "dense"])
def test_tokens_equal_jax_engine(served, run):
    g, _, jax_runs = served
    got = {u: r.tokens for u, r in g[f"res_{run}"].items()}
    assert got == jax_runs[run][0]
    assert all(len(t) == MAX_NEW for t in got.values())


def test_sparsity_and_kv_bytes_equal_jax_engine(served):
    g, jcfg, jax_runs = served
    s, js = g["s_hdp"], jax_runs["hdp"][1]
    for key in ("block_sparsity", "head_sparsity", "page_sparsity"):
        assert abs(s[key] - js[key]) <= SPARSITY_TOL, key
    assert s["block_sparsity"] > 0
    assert (s["page_size"], s["cache_bytes"]) == (js["page_size"],
                                                 js["cache_bytes"])
    assert s["attn_backend_decode"] == "pallas_paged_decode"
    assert g["s_dense"]["cache_bytes"] == jax_runs["dense"][1]["cache_bytes"]
    assert (g["dense_b"], g["hdp_b"]) == kv_read_bytes_per_step(
        jcfg, 32768, 1, js["block_sparsity"])
