"""Port parity of the Mamba2 layer and the zamba2 hybrid
(``repro_torch.models.mamba2``, ``zamba2``) on reduced zamba2-7b (fp32,
CPU): the same seeded inputs and weights (moved with
``params_from_jax``) through the JAX function and the port's, within
atol 1e-5 / rtol 1e-4 function by function and layer by layer. The
whole model is held to atol 1e-4 (the aligned prefill's limit, PERF.md
section 2): on random weights one Mamba2 layer (its gated RMSNorm of a
small ``y``) amplifies the fp32 sum-order differences of its input
about tenfold, so inputs 6e-6 apart came out 5.7e-5 apart at T = 16,
while every layer given the same input stays within 3.5e-6.

* ``_causal_conv`` (fp32 and bf16: the shifted adds in the input dtype,
  in Python's sum order), ``_ssd_scan``, and ``_ssd_chunked`` at T = 128
  and T = 256 (two chunks carrying the state);
* ``mamba2.layer_apply`` at a T of each branch (the per-step scan at
  T = 6, the chunked form at T = 8, with an SSD chunk of 4) from a
  nonzero state (decode's T = 1 runs below);
* zamba2 ``apply_prefill`` with a request cache (the serving call: every
  leaf of the cache tree), then four greedy ``apply_decode`` steps
  (logits, tokens, the Mamba2 states and the shared block's K/V), with
  HDP on; and with ``cache=None``, the aligned prefill, pinned to the
  full-sequence kernels' backends (HDP on: scout + block kernel; off:
  flash) as the card runs it, and resolved to them by default;
* a bf16 reduced config through ``params_from_jax`` keeps ``A_log`` in
  fp32 (and every other leaf in bf16), bit for bit; bf16 qwen2's leaves
  all stay bf16.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attention import AttnSpec as JSpec
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import mamba2 as jmamba2
from repro.models import registry as jregistry
from repro_torch.attention import AttnSpec
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import mamba2, registry, zamba2

from test_torch_rwkv6 import _np_tree

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
MODEL_ATOL = 1e-4
ARCH = "zamba2-7b"


def _close(t, j, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               atol=atol, rtol=rtol, err_msg=what)


def _cfgs(**kw):
    return (reduced(get_config(ARCH)).replace(**kw),
            jax_reduced(jax_get_config(ARCH)).replace(**kw))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    tree = _np_tree(registry.init_params(cfg, 5, "cpu"))
    params = params_from_jax(cfg, tree, "cpu")
    steps = (jax.jit(lambda p, b, c: jregistry.apply_prefill(jcfg, p, b, c)),
             jax.jit(lambda p, t, c, pos: jregistry.apply_decode(
                 jcfg, p, t, c, pos)))
    return cfg, jcfg, params, jax.tree.map(jnp.asarray, tree), steps


def test_config_matches_jax_field_for_field():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)), _cfgs()):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jregistry.param_count(jcfg)
        assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert registry.module_for(cfg) is zamba2
    assert registry.cache_specs(cfg) == jregistry.cache_specs(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jst = jmamba2._causal_conv(
        jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
        jnp.asarray(st).astype(jd) if with_state else None)
    ty, tst = mamba2._causal_conv(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        torch.from_numpy(st).to(td) if with_state else None)
    assert ty.dtype == td and tst.dtype == td
    # the same adds in the same order and dtype: bit-equal
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tst.float().numpy(),
                                  np.asarray(jst.astype(jnp.float32)))


def _ssd_inputs(T, seed, B=2, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return xh, dt, dt * A, Bm, Cm, s0


@pytest.mark.parametrize("T", [1, 9])
def test_ssd_scan_matches_jax(T):
    xh, dt, ld, Bm, Cm, s0 = _ssd_inputs(T, T)
    decay = np.exp(ld)
    args = (xh, dt, decay, Bm, Cm, s0)
    jy, js = jmamba2._ssd_scan(*map(jnp.asarray, args))
    ty, ts = mamba2._ssd_scan(*map(torch.from_numpy, args))
    _close(ty, jy, "y")
    _close(ts, js, "state")


@pytest.mark.parametrize("T", [128, 256])
def test_ssd_chunked_matches_jax(T):
    args = _ssd_inputs(T, T, B=1)
    jy, js = jmamba2._ssd_chunked(*map(jnp.asarray, args), chunk=128)
    ty, ts = mamba2._ssd_chunked(*map(torch.from_numpy, args), chunk=128)
    _close(ty, jy, "y")
    _close(ts, js, "state")


@pytest.mark.parametrize("T,branch", [(6, "scan"), (8, "chunked")])
def test_layer_apply_matches_jax_on_each_branch(model, T, branch,
                                                monkeypatch):
    cfg, jcfg, params, jparams, _ = model
    cfg, jcfg = cfg.replace(ssm_chunk=4), jcfg.replace(ssm_chunk=4)
    lp = {k: v[0, 0] for k, v in params["grouped"]["m"].items()}
    jlp = {k: v[0, 0] for k, v in jparams["grouped"]["m"].items()}
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    S = rng.standard_normal((2, mamba2.n_ssm_heads(cfg), cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32) * 0.1
    conv = rng.standard_normal((2, cfg.ssm_conv - 1,
                                mamba2.d_inner(cfg))).astype(np.float32)
    taken = []
    for name in ("_ssd_scan", "_ssd_chunked"):
        fn = getattr(mamba2, name)
        monkeypatch.setattr(mamba2, name,
                            lambda *a, _f=fn, _n=name, **k: (
                                taken.append(_n), _f(*a, **k))[1])
    jy, jc = jax.jit(jmamba2.layer_apply, static_argnums=0)(
        jcfg, jlp, jnp.asarray(x), {"S": jnp.asarray(S),
                                    "conv": jnp.asarray(conv)})
    with torch.no_grad():
        ty, tc = mamba2.layer_apply(cfg, lp, torch.from_numpy(x),
                                    {"S": torch.from_numpy(S),
                                     "conv": torch.from_numpy(conv)})
    assert taken == [f"_ssd_{branch}"]
    _close(ty, jy, "y")
    _close(tc["S"], jc["S"], "S")
    _close(tc["conv"], jc["conv"], "conv")


def test_prefill_with_cache_then_decode_matches_jax(model):
    """The serving call: a prompt of 11 (the chunked SSD at T = 11) into
    a request cache of 16 positions, then four greedy steps (per-slot
    positions [B, 1], the per-step scan)."""
    cfg, jcfg, params, jparams, (jprefill, jdecode) = model
    toks = np.random.default_rng(2).integers(1, 250, (2, 11)).astype(
        np.int32)
    jl, jc, _ = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                         jregistry.init_cache(jcfg, 2, 16))
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            registry.init_cache(cfg, 2, 16, device="cpu"))
    _close(tl, jl, "prefill logits", atol=MODEL_ATOL)
    flat = jax.tree_util.tree_leaves_with_path(jc)
    for step in range(5):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
            keys = [getattr(k, "key", k) for k in path]
            t = tc
            for k in keys:
                t = t[k]
            _close(t, leaf, f"{'/'.join(keys)} before step {step}",
                   atol=MODEL_ATOL)
        if step == 4:
            break
        tok = np.argmax(np.asarray(jl)[:, -1], -1)
        assert (tl[:, -1].argmax(-1).numpy() == tok).all(), step
        tok = tok[:, None].astype(np.int32)
        pos = np.full((2, 1), 11 + step, np.int32)
        jl, jc, _ = jdecode(jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc, _ = registry.apply_decode(
                cfg, params, torch.from_numpy(tok).long(), tc,
                torch.from_numpy(pos).long())
        _close(tl, jl, f"decode logits, step {step}", atol=MODEL_ATOL)
    assert len(flat) == 6          # mamba S/conv, attn k/v, tail S/conv


@pytest.mark.parametrize("backend,hdp_on", [("pallas_hdp_block", True),
                                            ("pallas_flash", False)])
def test_aligned_prefill_matches_jax(model, backend, hdp_on):
    """``cache=None``: the shared block's attention is an aligned
    self-attention prefill, pinned to the full-sequence kernels' backend
    without fallback in both packages (the JAX kernels in interpret
    mode, the port's plain versions); the default spec resolves the same
    backend (the reference's TPU order)."""
    cfg, jcfg, params, jparams, _ = model
    if not hdp_on:
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
        jcfg = jcfg.replace(hdp=jcfg.hdp.replace(enabled=False))
    toks = np.random.default_rng(7).integers(1, 250, (1, 16)).astype(
        np.int32)
    jl, jc, jst = jax.jit(lambda p, b: jregistry.apply_prefill(
        jcfg, p, b, None, attn=JSpec(backend=backend, allow_fallback=False),
        collect_stats=hdp_on))(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc, tst = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()}, None,
            attn=AttnSpec(backend=backend, allow_fallback=False),
            collect_stats=hdp_on)
        dl, _, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long()}, None)
    assert tc is None and jc is None
    _close(tl, jl, "logits", atol=MODEL_ATOL)
    np.testing.assert_array_equal(dl.numpy(), tl.numpy())
    if hdp_on:
        assert tst["block_sparsity"].shape[0] == zamba2.attn_layers(cfg)
        for name in ("block_sparsity", "head_sparsity"):
            _close(tst[name], jst[name], name)


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-1.5b"])
def test_params_from_jax_keeps_fp32_leaves_of_a_bf16_model(arch):
    """``A_log`` is fp32 in a bf16 zamba2 (the reference's init); the
    conversion takes each leaf's dtype from the port's own tree, so it
    stays fp32, bit for bit, and every other leaf is bf16, as every leaf
    of a bf16 qwen2 is."""
    cfg = reduced(get_config(arch)).replace(dtype="bfloat16")
    params = registry.init_params(cfg, 1, "cpu")
    if arch == "zamba2-7b":
        assert params["grouped"]["m"]["A_log"].dtype == torch.float32
        params["grouped"]["m"]["A_log"].uniform_(-1, 1)   # not bf16-exact
    tree = jax.tree.map(lambda t: t.float().numpy().astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else np.float32), params)
    out = params_from_jax(cfg, tree, "cpu")
    n_fp32 = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [getattr(k, "key", k) for k in path]
        t = out
        for k in keys:
            t = t[k]
        want = torch.float32 if keys[-1] == "A_log" else torch.bfloat16
        assert t.dtype == want, "/".join(keys)
        n_fp32 += want == torch.float32
        np.testing.assert_array_equal(t.float().numpy(),
                                      leaf.astype(np.float32))
    assert n_fp32 == (2 if arch == "zamba2-7b" else 0)   # grouped, tail
