"""Port of the attention-registry checks (``tests/test_attention_registry.py``).

* Resolution: for a matrix of call shapes and requests, the port's
  ``resolve_backend(...).name`` equals the JAX package's as it resolves
  on a TPU (``_on_tpu`` patched to True in the test: the port ranks by
  the reference's TPU order on every device), including the fallback
  rules, ``BackendUnsupported`` under ``allow_fallback=False`` and
  ``REPRO_ATTN_BACKEND``.
* Conformance: every port backend that supports a call agrees with the
  JAX ``reference`` oracle on the same numpy inputs (within the
  reference suite's ATOL = 2e-5).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.attention.registry as jregistry
from repro.attention import AttnCall as JCall
from repro.attention import AttnSpec as JSpec
from repro.attention import BackendUnsupported as JUnsupported
from repro.attention import attention as jattention
from repro.core.config import HDPConfig as JHDP
from repro_torch.attention import (AttnCall, AttnSpec, BackendUnsupported,
                                   attention, get_backend,
                                   known_backend_names, list_backends,
                                   resolve_backend)
from repro_torch.core.config import HDPConfig
from repro_torch.core.quant import pool_scale

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ATOL = 2e-5
B, N, G, HD = 1, 2, 2, 8
SQ = SK = 16
HDP_KW = dict(block_q=4, block_k=4, rho_b=0.5, tau_h=0.0,
              normalize_head_score=True, calib="max")
NAMES = ("reference", "xla_dense", "xla_hdp", "paged_hdp_decode",
         "pallas_flash", "pallas_hdp_block", "pallas_paged_decode")


def _calls(**kw):
    """The same call descriptor in both packages (hdp kw -> HDPConfig)."""
    hdp = kw.pop("hdp", None)
    return (JCall(hdp=None if hdp is None else JHDP(**hdp), **kw),
            AttnCall(hdp=None if hdp is None else HDPConfig(**hdp), **kw))


def _cells():
    cells = []
    for mode in ("prefill", "decode"):
        for causal in (True, False):
            for hdp_on in (True, False):
                cells.append(dict(
                    mode=mode, layout="dense", causal=causal,
                    hdp={**HDP_KW, "causal": causal} if hdp_on else None,
                    self_aligned=mode == "prefill"))
    for hdp_on in (True, False):
        cells.append(dict(
            mode="decode", layout="paged", causal=True, per_slot=True,
            hdp={**HDP_KW, "causal": True, "calib": "none"} if hdp_on
            else None))
    return cells


def _cell_id(c):
    return (f"{c['mode']}-{c['layout']}-"
            f"{'causal' if c['causal'] else 'full'}-"
            f"{'hdp' if c['hdp'] else 'dense'}")


# resolution-only shapes beyond the conformance grid
EXTRA = [
    dict(mode="prefill", hdp={**HDP_KW, "causal": True}),   # cache prefill
    dict(mode="prefill", self_aligned=True, trainable=True,
         hdp={**HDP_KW, "causal": True}),
    dict(mode="prefill", self_aligned=True, window=8),
    dict(mode="prefill", self_aligned=True, per_slot=True),
    dict(mode="prefill", self_aligned=True, causal=True,
         hdp={**HDP_KW, "causal": False}),
    dict(mode="decode", layout="paged", per_slot=True, causal=False,
         hdp={**HDP_KW, "causal": False}),
    dict(mode="decode", layout="paged", per_slot=True, window=8,
         hdp={**HDP_KW, "causal": True}),
    dict(mode="decode", layout="paged", per_slot=True, verify=True,
         hdp={**HDP_KW, "causal": True}),
    dict(mode="prefill", self_aligned=True,
         hdp={**HDP_KW, "causal": True, "approx_softmax": True}),
]
REQUESTS = ("auto", "pallas", "xla", "reference") + NAMES


@pytest.fixture
def on_tpu(monkeypatch):
    monkeypatch.setattr(jregistry, "_on_tpu", lambda: True)
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_ATTN_POLICY", raising=False)


def _resolve(resolve, call, spec, unsupported):
    try:
        return resolve(call, spec).name
    except unsupported:
        return "BackendUnsupported"


@pytest.mark.parametrize("cell", _cells() + EXTRA,
                         ids=[_cell_id({"layout": "dense", "causal": True,
                                        "hdp": None, **c}) + f"-{i}"
                              for i, c in enumerate(_cells() + EXTRA)])
def test_resolution_matches_jax_on_tpu(cell, on_tpu):
    jcall, tcall = _calls(**cell)
    for req in REQUESTS:
        for fb in (True, False):
            want = _resolve(jregistry.resolve_backend, jcall,
                            JSpec(backend=req, allow_fallback=fb),
                            JUnsupported)
            got = _resolve(resolve_backend, tcall,
                           AttnSpec(backend=req, allow_fallback=fb),
                           BackendUnsupported)
            assert got == want, (req, fb)


def test_per_mode_overrides_and_unknown_names(on_tpu):
    jcall, tcall = _calls(mode="decode", layout="paged", per_slot=True,
                          hdp={**HDP_KW, "causal": True})
    spec = dict(backend="reference", decode="pallas_hdp_block")
    assert resolve_backend(tcall, AttnSpec(**spec)).name == \
        jregistry.resolve_backend(jcall, JSpec(**spec)).name == \
        "pallas_hdp_block"
    with pytest.raises(KeyError):
        resolve_backend(tcall, AttnSpec(backend="not-a-backend"))
    assert set(known_backend_names()) == set(
        jregistry.known_backend_names())
    assert {b.name for b in list_backends()} == set(NAMES)
    for name in NAMES:
        j, t = jregistry.get_backend(name), get_backend(name)
        assert (t.priority, t.tags) == (j.tpu_priority, j.tags), name


def test_env_var_forces_every_auto_resolution(monkeypatch, on_tpu):
    monkeypatch.setenv("REPRO_ATTN_BACKEND", "reference")
    jcall, tcall = _calls(mode="prefill", self_aligned=True,
                          hdp={**HDP_KW, "causal": True})
    for spec in ({}, {"layout": "dense"}, {"backend": "xla"},
                 {"backend": "pallas"}):
        assert resolve_backend(tcall, AttnSpec(**spec)).name == \
            jregistry.resolve_backend(jcall, JSpec(**spec)).name, spec
    assert resolve_backend(tcall).name == "reference"
    assert resolve_backend(tcall, AttnSpec(backend="xla")).name == "xla_hdp"


def test_cost_policy_resolves_like_jax(monkeypatch, on_tpu):
    """``AttnSpec(policy="cost")`` constructs, and under the cost policy
    (explicit, or policy "auto" with ``REPRO_ATTN_POLICY=cost``) the
    port and JAX resolve the same calls alike through a ``HOST_CPU``
    tuner of each package; ``REPRO_ATTN_BACKEND`` still wins over it,
    and without a signature the static order decides."""
    from repro.autotune import Tuner as JTuner
    from repro.autotune import call_signature as jsig
    from repro.roofline.hardware import HOST_CPU as J_CPU
    from repro_torch.attention import POLICY_ENV, effective_policy
    from repro_torch.autotune import Tuner, call_signature
    from repro_torch.roofline.hardware import HOST_CPU

    assert AttnSpec(policy="cost").policy == "cost"
    monkeypatch.setenv(POLICY_ENV, "cost")
    assert effective_policy(AttnSpec()) == \
        jregistry.effective_policy(JSpec()) == "cost"
    assert effective_policy(AttnSpec(policy="static")) == "static"
    cells = [dict(mode="decode", layout="paged", per_slot=True,
                  hdp={**HDP_KW, "causal": True}),
             dict(mode="decode", layout="paged", per_slot=True, verify=True,
                  hdp={**HDP_KW, "causal": True}),
             dict(mode="decode", layout="dense", per_slot=True,
                  hdp={**HDP_KW, "causal": True}),
             dict(mode="decode", layout="dense"),
             dict(mode="prefill", hdp={**HDP_KW, "causal": True}),
             dict(mode="prefill", self_aligned=True)]
    jt, tt = JTuner(hw=J_CPU), Tuner(hw=HOST_CPU)
    for cell in cells:
        jcall, tcall = _calls(**cell)
        sq = 1 if cell["mode"] == "decode" else SQ
        q = np.zeros((B, N, G, sq, HD), np.float32)
        k = np.zeros((B, SK, N, HD), np.float32)
        kw = {}
        if cell.get("layout") == "paged":
            kw = dict(cache={"k_pages": np.zeros((5, 4, N, HD), np.int8)},
                      page_table=np.zeros((B, 4), np.int32))
        jkw = {n: _to(v, jnp.asarray) for n, v in kw.items()}
        tkw = {n: _to(v, torch.from_numpy) for n, v in kw.items()}
        js = jsig(jcall, jnp.asarray(q), k=jnp.asarray(k), **jkw)
        ts = call_signature(tcall, torch.from_numpy(q),
                            k=torch.from_numpy(k), **tkw)
        assert ts.key() == js.key()
        for spec_kw in ({}, {"policy": "cost"}):
            want = jregistry.resolve_backend(jcall, JSpec(**spec_kw),
                                             sig=js, tuner=jt).name
            got = resolve_backend(tcall, AttnSpec(**spec_kw), sig=ts,
                                  tuner=tt).name
            assert got == want, (cell, spec_kw)
            # without a signature the static (TPU-rank) order decides
            assert resolve_backend(tcall, AttnSpec(**spec_kw)).name == \
                jregistry.resolve_backend(jcall, JSpec(**spec_kw)).name
        monkeypatch.setenv("REPRO_ATTN_BACKEND", "reference")
        assert resolve_backend(tcall, AttnSpec(policy="cost"), sig=ts,
                               tuner=tt).name == "reference" == \
            jregistry.resolve_backend(jcall, JSpec(policy="cost"), sig=js,
                                      tuner=jt).name
        monkeypatch.delenv("REPRO_ATTN_BACKEND")
    assert tt.decision == jt.decision and set(tt.pending) == set(jt.pending)
    assert (tt.hits, tt.misses) == (jt.hits, jt.misses)


def test_call_validation():
    off = AttnCall(mode="prefill", hdp=HDPConfig(enabled=False))
    assert off.hdp is None
    with pytest.raises(ValueError):
        AttnCall(mode="prefill", layout="paged")
    with pytest.raises(ValueError):
        AttnCall(mode="prefill", verify=True)


# ------------------------------------------------------------ conformance
def _inputs(cell, seed=0):
    """numpy inputs of one cell: dense q/k/v, or an int8 paged pool."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if cell["layout"] == "paged":
        ps, n_pages = HDP_KW["block_k"], 4
        P = 1 + n_pages
        q = rng.standard_normal((B, N, G, 1, HD)).astype(f32)
        kp = rng.integers(-127, 128, (P, ps, N, HD)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, ps, N, HD)).astype(np.int8)
        sc = np.full((P, N), pool_scale(4), f32)
        table = np.arange(1, P, dtype=np.int32).reshape(B, n_pages)
        sk = n_pages * ps
        pos = np.full((B, 1), sk - 1, np.int32)
        ar = np.arange(sk)
        k_pos = np.where(ar[None] <= pos, ar, -1)[:, None, None, :]
        return dict(q=q, k=None, v=None, q_pos=pos[:, None, None, :],
                    k_pos=k_pos.astype(np.int32), page_table=table,
                    cache={"k_pages": kp, "v_pages": vp, "k_scale": sc,
                           "v_scale": sc.copy()})
    sq = SQ if cell["mode"] == "prefill" else 1
    return dict(q=rng.standard_normal((B, N, G, sq, HD)).astype(f32),
                k=rng.standard_normal((B, SK, N, HD)).astype(f32),
                v=rng.standard_normal((B, SK, N, HD)).astype(f32),
                q_pos=np.arange(SQ) if sq == SQ else np.asarray([SK - 1]),
                k_pos=np.arange(SK), cache=None, page_table=None)


def _to(x, fn):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


@pytest.mark.parametrize("cell", _cells(), ids=_cell_id)
def test_backends_agree_with_jax_reference(cell):
    jcall, tcall = _calls(**cell)
    x = _inputs(cell)
    jx = {k: _to(v, jnp.asarray) for k, v in x.items()}
    tx = {k: _to(v, torch.from_numpy) for k, v in x.items()}
    want, _ = jattention(jx["q"], jx["k"], jx["v"], jcall,
                         spec=JSpec(backend="reference"), q_pos=jx["q_pos"],
                         k_pos=jx["k_pos"], cache=jx["cache"],
                         page_table=jx["page_table"])
    ran = []
    for b in list_backends():
        if not b.supports(tcall):
            continue
        spec = AttnSpec(backend=b.name, allow_fallback=False)
        kw = dict(spec=spec, q_pos=tx["q_pos"], k_pos=tx["k_pos"],
                  cache=tx["cache"], page_table=tx["page_table"])
        with torch.no_grad():
            out, _ = attention(tx["q"], tx["k"], tx["v"], tcall, **kw)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL,
            err_msg=f"{b.name} disagrees with the JAX reference on "
                    f"{_cell_id(cell)}")
        ran.append(b.name)
    assert "reference" in ran
