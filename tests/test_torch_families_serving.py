"""Port parity of serving the moe and vlm model stack: the port's
``Engine`` on the CPU (plain kernel versions) and the JAX ``Engine``
serve the same prompts with the same weights from the int8 pool and
emit the same greedy tokens on reduced olmoe-1b-7b, llama4-scout-17b-a16e,
chameleon-34b (the two with qk-norm, whose K is normed before the pool
snap) and nemotron-4-15b; on reduced olmoe also speculative decode
(draft_len 4) and prefix-cache hits, which equal the port's own greedy
and cold runs (the reduced configs' capacity factor of 4.0 drops no
token, so the MoE routes a token alike however its sequence is cut).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.attention import AttnSpec
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine, Request

from test_torch_families import ARCHS, KW, _cfgs

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)


def _prompts(n, lo=4, hi=24, seed=0, vocab=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _run(eng, R, prompts, max_new=5):
    for uid, p in enumerate(prompts):
        eng.submit(R(uid, p, max_new_tokens=max_new))
    return {u: r.tokens for u, r in eng.run().items()}


def _engines(arch, **jkw):
    """The JAX engine (XLA backends, int8 pool, per-token decode, no
    stream scheduler) and the port's weights converted from its own."""
    _, jcfg = _cfgs(arch)
    jkw = {"decode_horizon": 1, "prefix_cache": False, "spec_decode": False,
           **jkw}
    jeng = JEngine(jcfg, attn=JSpec(backend="xla", kv_dtype="int8"),
                   stream_sched=False, **jkw, **KW)
    cfg, _ = _cfgs(arch)
    return jeng, params_from_jax(cfg, jax.tree.map(np.asarray, jeng.params),
                                 "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax_engine(arch):
    """Four prompts (one of 40 tokens: chunked past the 32 bucket), five
    new tokens each, from the int8 pool."""
    prompts = _prompts(3, seed=7) + _prompts(1, lo=40, hi=41, seed=8)
    jeng, params = _engines(arch)
    cfg, _ = _cfgs(arch)
    eng = Engine(cfg, params, device="cpu", attn=AttnSpec(kv_dtype="int8"),
                 **KW)
    jtok = _run(jeng, JRequest, prompts)
    tok = _run(eng, Request, prompts)
    assert tok == jtok
    js, ts = jeng.summary(), eng.summary()
    for key in ("attn_backend_prefill", "kv_dtype", "cache_bytes",
                "cache_bytes_per_token", "pages_peak", "prefill_calls"):
        assert ts[key] == js[key], key


def _shared_prompts():
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 250, size=16).tolist()
    return [shared + rng.integers(1, 250, size=4 + i).tolist()
            for i in range(3)] + [shared[:12], shared]


def test_olmoe_spec_and_prefix_equal_jax_engine():
    """Reduced olmoe: speculative decode at draft_len 4 gives the port's
    greedy tokens and the JAX engine's; prefix-cache hits give the
    port's cold tokens and the JAX engine's, with the same hit counts."""
    arch = "olmoe-1b-7b"
    cfg, _ = _cfgs(arch)
    prompts = _prompts(4, seed=3)
    jeng, params = _engines(arch)
    jeng.spec, jeng.draft_len = True, 4
    jspec = _run(jeng, JRequest, prompts, 6)
    greedy = _run(Engine(cfg, params, device="cpu", **KW), Request, prompts,
                  6)
    seng = Engine(cfg, params, device="cpu", spec_decode=True, draft_len=4,
                  **KW)
    spec = _run(seng, Request, prompts, 6)
    assert spec == greedy == jspec
    assert seng.summary()["spec_rounds"] > 0

    jeng, _ = _engines(arch, prefix_cache=True)
    shared = _shared_prompts()
    jhot = _run(jeng, JRequest, shared, 4)
    cold = _run(Engine(cfg, params, device="cpu", prefix_cache=False, **KW),
                Request, shared, 4)
    heng = Engine(cfg, params, device="cpu", prefix_cache=True, **KW)
    hot = _run(heng, Request, shared, 4)
    assert hot == cold == jhot
    hs, js = heng.summary(), jeng.summary()
    assert hs["prefix_hits"] > 0
    for key in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                "prefill_tokens"):
        assert hs[key] == js[key], key
