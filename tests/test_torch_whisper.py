"""Port parity of the whisper family (``repro_torch.models.whisper``) on
reduced whisper-large-v3 (fp32, CPU): the same seeded frames, tokens
and weights (moved with ``params_from_jax``) through the JAX function
and the port's, within atol 1e-5 / rtol 1e-4.

* ``layers.sinusoidal_pos`` at even widths and offsets (an int and a
  position tensor), and an odd width, which raises in both packages;
* ``encode`` (the stub frontend, the sinusoid, the non-causal encoder);
* ``apply_prefill`` (encode, the prompt, both caches filled) and eight
  greedy ``apply_decode`` steps (the self cache written per step, the
  cross cache read as it is): logits and caches within tolerance, the
  tokens exactly equal;
* the backend each attention call resolves (the encoder's trainable
  non-causal call, the decoder's self-attention at prefill and decode,
  and its cross-attention at prefill and decode) equals JAX's, with HDP
  on and off, in the reference's TPU order (the port's on every device);
* ``Engine`` refuses an encoder-decoder config in both packages.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.attention.registry as jreg_mod
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro.models.attention import build_attn_call as jbuild
from repro.serving import Engine as JEngine
from repro_torch.attention import resolve_backend
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import registry, whisper
from repro_torch.models.attention import build_attn_call
from repro_torch.serving import Engine

from test_torch_rwkv6 import _np_tree

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
ARCH = "whisper-large-v3"
B, S_ENC, PLEN = 2, 24, 6


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _cfgs():
    return reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    tree = _np_tree(registry.init_params(cfg, 2, "cpu"))
    params = params_from_jax(cfg, tree, "cpu")
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, 250, (B, PLEN)).astype(np.int32)
    return cfg, jcfg, params, jax.tree.map(jnp.asarray, tree), frames, toks


def test_config_matches_jax_field_for_field():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)), _cfgs()):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jregistry.param_count(jcfg)
        assert cfg.is_encoder_decoder and jcfg.is_encoder_decoder
    assert registry.module_for(cfg) is whisper
    assert registry.cache_specs(cfg) == jregistry.cache_specs(jcfg)


@pytest.mark.parametrize("seq,d,offset", [(9, 64, 0), (5, 10, 3),
                                          (1, 64, "tensor")])
def test_sinusoidal_pos_matches_jax(seq, d, offset):
    if offset == "tensor":        # the decoder's positions[0] of [B, 1]
        jo, to = jnp.asarray([37], jnp.int32), torch.tensor([37])
    else:
        jo, to = offset, offset
    want = JL.sinusoidal_pos(seq, d, offset=jo)
    got = L.sinusoidal_pos(seq, d, offset=to)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    _close(got, want, "table")


@pytest.mark.parametrize("d", [5, 7])
def test_sinusoidal_pos_odd_width_raises_like_jax(d):
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JL.sinusoidal_pos(3, d)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        L.sinusoidal_pos(3, d)


def test_encode_matches_jax(model):
    cfg, jcfg, params, jparams, frames, _ = model
    jy, _ = jax.jit(lambda p, f: jwhisper.encode(jcfg, p, f))(
        jparams, jnp.asarray(frames))
    with torch.no_grad():
        ty, _ = whisper.encode(cfg, params, torch.from_numpy(frames))
    _close(ty, jy, "encoder states")


def test_prefill_then_greedy_decode_matches_jax(model):
    cfg, jcfg, params, jparams, frames, toks = model
    max_len = PLEN + 8
    jl, jc, _ = jax.jit(lambda p, b, c: jregistry.apply_prefill(
        jcfg, p, b, c))(jparams, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)},
                        jregistry.init_cache(jcfg, B, max_len,
                                             enc_len=S_ENC))
    with torch.no_grad():
        tl, tc, _ = registry.apply_prefill(
            cfg, params, {"tokens": torch.from_numpy(toks).long(),
                          "frames": torch.from_numpy(frames)},
            registry.init_cache(cfg, B, max_len, device="cpu",
                                enc_len=S_ENC))
    _close(tl, jl, "prefill logits")
    # the reference's decode as called, eagerly: jitted, XLA rounds the
    # HDP decode's "max" calibration apart at one step of these eight
    # (7.0e-5 in the logits against the eager call; ROADMAP.md section 3)
    def jdecode(p, t, c, pos):
        return jregistry.apply_decode(jcfg, p, t, c, pos)

    jtoks, ttoks = [], []
    for step in range(8):
        for part in ("self", "cross"):
            for name in ("k", "v"):
                _close(tc[part][name], jc[part][name],
                       f"{part}/{name} before step {step}")
        jt = np.argmax(np.asarray(jl)[:, -1], -1)
        tt = tl[:, -1].argmax(-1).numpy()
        jtoks.append(jt)
        ttoks.append(tt)
        pos = np.full((B, 1), PLEN + step, np.int32)
        jl, jc, _ = jdecode(jparams, jnp.asarray(jt[:, None].astype(np.int32)),
                            jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc, _ = registry.apply_decode(
                cfg, params, torch.from_numpy(tt[:, None]).long(), tc,
                torch.from_numpy(pos).long())
        _close(tl, jl, f"decode logits, step {step}")
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


#: (what, build_attn_call keyword arguments): each attention call of the
#: model, as ``attn_apply`` describes it
CALLS = [
    ("encoder", dict(mode="train", causal=False)),
    ("self prefill", dict(mode="prefill")),
    ("self decode", dict(mode="decode", per_slot=True)),
    ("cross prefill", dict(mode="prefill", cross=True)),
    ("cross decode", dict(mode="decode", per_slot=True, cross=True)),
]


@pytest.mark.parametrize("hdp_on", [True, False])
def test_resolved_backends_equal_jax(monkeypatch, hdp_on):
    monkeypatch.setattr(jreg_mod, "_on_tpu", lambda: True)
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    cfg, jcfg = _cfgs()
    cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=hdp_on))
    jcfg = jcfg.replace(hdp=jcfg.hdp.replace(enabled=hdp_on))
    got = {}
    for what, kw in CALLS:
        tcall, jcall = build_attn_call(cfg, **kw), jbuild(jcfg, **kw)
        assert (tcall.causal, tcall.window, tcall.trainable) == \
            (jcall.causal, jcall.window, jcall.trainable), what
        assert (tcall.hdp is None) == (jcall.hdp is None), what
        got[what] = resolve_backend(tcall).name
        assert got[what] == jreg_mod.resolve_backend(jcall).name, what
    # trainable calls take no HDP and no kernel backend
    assert got["encoder"] == "xla_dense"
    assert got["self prefill"] == ("xla_hdp" if hdp_on else "xla_dense")


def test_engine_refuses_encoder_decoder(model):
    cfg, jcfg, params, jparams, _, _ = model
    with pytest.raises(NotImplementedError):
        JEngine(jcfg, params=jparams, max_batch=1, max_len=32)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        Engine(cfg, params, device="cpu", max_batch=1, max_len=32)
