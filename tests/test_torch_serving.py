"""Port parity of the serving engine: the port's ``Engine`` on the CPU
(plain kernel versions) and the JAX ``Engine`` serve the same prompts
with the same weights, and must emit byte-identical greedy tokens and
the same HDP sparsity. The JAX engine is pinned to the int8 pool,
per-token decode and the XLA backends, so environment legs of the
reference's CI cannot change what it serves."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import AttnSpec as TAttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.serving import Engine, Request

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

KW = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _serve_jax(params, prompts, max_new, eos=None):
    eng = JEngine(jax_reduced(jax_get_config("qwen2-1.5b")), params=params,
                  attn=AttnSpec(backend="xla", kv_dtype="int8"),
                  decode_horizon=1, prefix_cache=False, spec_decode=False,
                  stream_sched=False, collect_stats=True, **KW)
    for uid, p in enumerate(prompts):
        eng.submit(JRequest(uid, p, max_new_tokens=max_new, eos_id=eos))
    return eng, {u: r.tokens for u, r in eng.run().items()}


def _serve_torch(params, prompts, max_new, eos=None):
    eng = Engine(reduced(get_config("qwen2-1.5b")), params, device="cpu",
                 collect_stats=True, **KW)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=max_new, eos_id=eos))
    return eng, {u: r.tokens for u, r in eng.run().items()}


@pytest.fixture(scope="module")
def served():
    """4 prompts x 5 new tokens through both engines, same weights."""
    prompts = _prompts(4, seed=3)
    jeng, jtok = _serve_jax(None, prompts, 5)
    tree = jax.tree.map(np.asarray, jeng.params)
    params = params_from_jax(reduced(get_config("qwen2-1.5b")), tree, "cpu")
    eng, tok = _serve_torch(params, prompts, 5)
    return dict(prompts=prompts, jeng=jeng, jtok=jtok, eng=eng, tok=tok,
                jparams=jeng.params, params=params)


def test_greedy_tokens_equal_jax_engine(served):
    assert served["tok"] == served["jtok"]
    assert all(len(t) == 5 for t in served["tok"].values())


def test_summary_matches_jax_engine(served):
    js, ts = served["jeng"].summary(), served["eng"].summary()
    for key in ("block_sparsity", "head_sparsity", "page_sparsity",
                "cache_bytes_per_token", "cache_bytes", "pages_peak",
                "decode_steps", "tokens_out", "prefill_calls",
                "prefill_tokens"):
        assert ts[key] == js[key], key
    assert ts["completed"] == 4
    assert ts["attn_decode_stage3"].startswith("plain")
    assert ts["decode_tok_s"] > 0


def test_pages_conserved_after_run(served):
    eng = served["eng"]
    eng.pages.allocator.assert_drained()
    assert eng.pages.pages_in_use == 0
    assert not eng.pages.table().any()
    assert eng.pages.peak_pages > 0
    assert sorted(eng._free) == list(range(KW["max_batch"]))


def test_eos_stops_like_jax_engine(served):
    """A request stops at its EOS id in both engines (the EOS token is
    the third greedy token of request 0)."""
    eos = served["jtok"][0][2]
    _, jtok = _serve_jax(served["jparams"], served["prompts"], 5, eos)
    _, tok = _serve_torch(served["params"], served["prompts"], 5, eos)
    assert tok == jtok
    assert tok[0] == served["jtok"][0][:3]


def test_run_budget_marks_incomplete(served):
    eng = Engine(reduced(get_config("qwen2-1.5b")), served["params"],
                 device="cpu", **KW)
    for uid, p in enumerate(served["prompts"]):
        eng.submit(Request(uid, p, max_new_tokens=5))
    res = eng.run(max_steps=2)
    assert not all(r.complete for r in res.values())
    res = eng.run()
    assert {u: r.tokens for u, r in res.items()} == served["tok"]
    assert all(r.complete for r in res.values())


def test_submit_validation(served):
    """A prompt past the largest bucket is chunked when the largest bucket
    is a multiple of HDP's block_q (2 here), and refused, naming that
    rule, when it is not."""
    eng = Engine(reduced(get_config("qwen2-1.5b")), served["params"],
                 device="cpu", **KW)
    eng.submit(Request(0, [5] * 40, max_new_tokens=4))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(1, [5] * 30, max_new_tokens=40))
    odd = Engine(reduced(get_config("qwen2-1.5b")), served["params"],
                 device="cpu", max_batch=2, max_len=64,
                 prefill_buckets=(15,))
    with pytest.raises(ValueError, match="largest prefill bucket .*multiple "
                                         "of HDP's block_q"):
        odd.submit(Request(0, [5] * 40, max_new_tokens=4))


def test_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(reduced(get_config("qwen2-1.5b")))


def test_serve_cli_on_cpu(capsys):
    rc = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                     "--max-new", "3", "--max-batch", "2"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"completed": 3' in out and '"kv_dtype": "int8"' in out


def test_block_kernel_engine_equals_jax_engine(served):
    """``attn="pallas_hdp_block"`` routes the paged decode through the
    block-sparse kernel on a densified gather (its plain version here,
    the JAX kernel in interpret mode there): greedy tokens and sparsity
    equal the JAX engine's under the same spec, and the resolved
    backends agree (prefill into a request cache falls back to
    xla_hdp in both)."""
    spec = AttnSpec(backend="pallas_hdp_block", kv_dtype="int8")
    jeng = JEngine(jax_reduced(jax_get_config("qwen2-1.5b")),
                   params=served["jparams"], attn=spec, decode_horizon=1,
                   prefix_cache=False, spec_decode=False, stream_sched=False,
                   collect_stats=True, **KW)
    eng = Engine(reduced(get_config("qwen2-1.5b")), served["params"],
                 device="cpu", collect_stats=True, attn="pallas_hdp_block",
                 **KW)
    for e, R in ((jeng, JRequest), (eng, Request)):
        for uid, p in enumerate(served["prompts"]):
            e.submit(R(uid, p, max_new_tokens=5))
    jtok = {u: r.tokens for u, r in jeng.run().items()}
    tok = {u: r.tokens for u, r in eng.run().items()}
    assert tok == jtok == served["jtok"]
    js, ts = jeng.summary(), eng.summary()
    for key in ("block_sparsity", "head_sparsity", "page_sparsity",
                "attn_backend_prefill", "attn_backend_decode"):
        assert ts[key] == js[key], key
    assert ts["attn_backend_decode"] == "pallas_hdp_block"
    assert ts["attn_decode_stage3"] == "plain:hdp_block_sparse_attention_plain"


def test_default_engine_reports_resolved_backends(served):
    s = served["eng"].summary()
    assert s["attn_backend_prefill"] == "xla_hdp"
    assert s["attn_backend_decode"] == "pallas_paged_decode"
    with pytest.raises(ValueError, match="decode"):
        Engine(reduced(get_config("qwen2-1.5b")), served["params"],
               device="cpu", attn=TAttnSpec(decode="palas"), **KW)


def test_serve_cli_backend_flag(capsys):
    rc = serve.main(["--device", "cpu", "--reduced", "--requests", "2",
                     "--max-new", "2", "--max-batch", "2", "--backend",
                     "pallas_hdp_block"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"attn_backend_decode": "pallas_hdp_block"' in out
