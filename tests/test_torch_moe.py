"""Port parity of the MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same seeded inputs and weights
(fp32, CPU): output and aux loss within 1e-6, the routing (top-K experts
and the drop mask of the capacity slots) exactly equal.

* reduced olmoe-1b-7b (4 experts, top-2) and reduced llama4-scout
  (top-1 plus the shared expert), at their reduced capacity factor (4.0:
  nothing drops) and at 1.0, where tokens drop;
* a narrow config with 32 experts, top-8 and S 4096, which takes the
  grouped branch (Sg 256, 16 groups of capacity 80);
* exact ties among router probabilities: the lower expert index wins,
  as ``jax.lax.top_k`` orders them;
* at olmoe's published capacity factor (1.25) on reduced olmoe, the
  reference's own engine drops tokens in the verify and the suffix
  prefill, so its speculative tokens differ from its greedy ones and its
  prefix hits from its cold runs; the port's engine gives the
  reference's tokens in all four runs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as M
from repro_torch.serving import Engine, Request

from test_torch_families_serving import (KW, _prompts, _run,
                                         _shared_prompts)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

TOL = 1e-6


def _cfgs(arch, **kw):
    return (reduced(get_config(arch)).replace(**kw),
            jax_reduced(jax_get_config(arch)).replace(**kw))


def _params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return M.moe_init(cfg, gen, "float32", "cpu")


def _jtree(p):
    return {k: (_jtree(v) if isinstance(v, dict) else jnp.asarray(v.numpy()))
            for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _jax_route(cfg, p, x):
    """The reference's routing (``repro/models/moe.py``, the lines after
    its group choice), for the drop mask it does not return:
    (top_i, fits) [B,G,Sg,K]."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    Sg = M.group_size(cfg, S)
    G = S // Sg
    capacity = max(1, int(cfg.capacity_factor * Sg * K / E))
    xg = x.reshape(B, G, Sg, D)
    logits = jnp.einsum("bgsd,de->bgse", xg, p["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, K)
    onehot_e = jax.nn.one_hot(top_i, E, dtype=jnp.float32)
    flat = onehot_e.reshape(B, G, Sg * K, E)
    pos = jnp.cumsum(flat, axis=2) - flat
    pos = (pos * flat).sum(-1).reshape(B, G, Sg, K).astype(jnp.int32)
    return np.asarray(top_i), np.asarray(pos < capacity)


def _check(cfg, jcfg, p, x):
    """Port vs reference on one input; returns the drop mask."""
    jp = _jtree(p)
    jy, jaux = JM.moe_apply(jcfg, jp, jnp.asarray(x))
    y, aux = M.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=TOL, rtol=TOL)
    B, S, D = x.shape
    Sg = M.group_size(cfg, S)
    _, _, top_i, _, _, fits, _ = M.route(
        cfg, p, torch.from_numpy(x).reshape(B, S // Sg, Sg, D))
    jtop_i, jfits = _jax_route(jcfg, jp, jnp.asarray(x))
    np.testing.assert_array_equal(top_i.numpy(), jtop_i)
    np.testing.assert_array_equal(fits.numpy(), jfits)
    return fits.numpy()


@pytest.mark.parametrize("capacity_factor", [None, 1.0],
                         ids=["reduced", "dropping"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_moe_matches_jax(arch, capacity_factor):
    kw = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    cfg, jcfg = _cfgs(arch, **kw)
    assert (cfg.n_experts, bool(cfg.n_shared_experts)) == (
        (4, False) if arch == "olmoe-1b-7b" else (4, True))
    p = _params(cfg, 0)
    fits = _check(cfg, jcfg, p, _x((2, 24, cfg.d_model), 1))
    if capacity_factor is None:
        assert fits.all(), "the reduced capacity factor must drop nothing"
    else:
        assert 0 < (~fits).sum() < fits.size, "expected some drops"


def test_moe_grouped_branch_matches_jax():
    """E 32, K 8, S 4096: the ungrouped dispatch would hold 4096 x 32 x
    1280 entries (> 64 Mi), so capacity is enforced per 256 tokens."""
    cfg, jcfg = _cfgs("olmoe-1b-7b", n_experts=32, n_experts_active=8,
                      capacity_factor=1.25, d_model=16, d_ff=16)
    S = 4096
    assert M.group_size(cfg, S) == 256
    p = _params(cfg, 2)
    fits = _check(cfg, jcfg, p, _x((1, S, cfg.d_model), 3))
    assert fits.shape == (1, 16, 256, 8)
    assert 0 < (~fits).sum(), "expected drops at capacity 80"
    # S 2048 stays ungrouped at olmoe's width (the reference's rule)
    full = get_config("olmoe-1b-7b")
    assert M.group_size(full, 2048) == 2048
    assert M.group_size(full, 4096) == 256


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_moe_ties_go_to_the_lower_expert(tie):
    """Equal router columns give bit-equal probabilities; the top-K then
    lists the lower expert first, as jax.lax.top_k does."""
    cfg, jcfg = _cfgs("olmoe-1b-7b", n_experts=8, n_experts_active=3,
                      capacity_factor=1.0)
    p = _params(cfg, 4)
    r = p["router"]
    if tie == "all":
        r.zero_()                       # every probability 1/E
    else:
        r[:, 5] = r[:, 2]               # experts 2 and 5 always tie
        r[:, 6] = r[:, 2]
    x = _x((2, 16, cfg.d_model), 5)
    _check(cfg, jcfg, p, x)
    _, _, top_i, _, _, fits, _ = M.route(
        cfg, p, torch.from_numpy(x).reshape(2, 1, 16, cfg.d_model))
    if tie == "all":
        assert (top_i == torch.arange(3)).all()
        # capacity int(1.0 * 16 * 3 / 8) = 6: tokens 0-5 fit, s-major
        assert fits[:, :, :6].all() and not fits[:, :, 6:].any()
    else:
        # wherever 2 leads, 5 and 6 follow it in that order
        rows = [r for r in top_i.reshape(-1, 3).tolist() if r[0] == 2]
        assert rows and all(r == [2, 5, 6] for r in rows)


def test_capacity_drops_serve_like_jax_engine():
    """Reduced olmoe at capacity factor 1.25: a verify of 4 tokens x 2
    choices has capacity 2 per expert and drops, and a suffix prefill
    groups its tokens unlike the whole prompt's. The reference's engine
    then gives spec != greedy and hot != cold; the port gives its tokens
    in each of the four runs."""
    cfg, jcfg = _cfgs("olmoe-1b-7b", capacity_factor=1.25)

    def jax_engine(**kw):
        kw = {"decode_horizon": 1, "prefix_cache": False,
              "spec_decode": False, **kw}
        return JEngine(jcfg, attn=JSpec(backend="xla", kv_dtype="int8"),
                       stream_sched=False, **kw, **KW)

    jeng = jax_engine()
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jeng.params),
                             "cpu")
    prompts, shared = _prompts(4, seed=3), _shared_prompts()
    want = {"greedy": _run(jeng, JRequest, prompts, 8)}
    jeng.spec, jeng.draft_len = True, 4
    want["spec"] = _run(jeng, JRequest, prompts, 8)
    want["cold"] = _run(jax_engine(params=jeng.params), JRequest, shared, 6)
    want["hot"] = _run(jax_engine(params=jeng.params, prefix_cache=True),
                       JRequest, shared, 6)
    assert want["spec"] != want["greedy"] and want["hot"] != want["cold"]
    got = {
        "greedy": dict(spec_decode=False), "spec": dict(spec_decode=True,
                                                         draft_len=4),
        "cold": dict(prefix_cache=False), "hot": dict(prefix_cache=True)}
    for run, kw in got.items():
        eng = Engine(cfg, params, device="cpu", **kw, **KW)
        toks = _run(eng, Request, shared if run in ("hot", "cold")
                    else prompts, 6 if run in ("hot", "cold") else 8)
        assert toks == want[run], run
