"""Port parity of the cost-driven autotune subsystem (CPU).

The unit classes of ``tests/test_autotune.py`` on the port —
``TestHardware``, ``TestCallSig``, ``TestPredict``, ``TestCrossover``,
``TestTuner``, ``TestPolicy`` and ``TestSpecController`` — with the
port's ``H100_SXM`` profile where the reference uses its TPU's, plus
checks across the two packages:

* ``predict`` under ``HOST_CPU`` (and under the H100 profile, rebuilt
  as a reference profile) over a sweep of signatures equals the
  reference's bit for bit: flops, bytes, overhead and step time;
* ``call_signature`` of torch and jnp tensors of the same shapes and
  dtypes gives equal keys;
* ``Tuner.choose`` over the sweep leaves equal decisions and pending
  probes in both packages, and ``crossover_table`` equal rows;
* ``SpecController`` fed one seeded accept stream plans the same
  ``(k, tier)`` sequence and summary;
* a ``Tuner.save`` of either package loads in the other.

``TestHloAgreement`` becomes ``TestFlopAgreement``: the analytic FLOPs
against ``torch.utils.flop_counter.FlopCounterMode`` over the port's
``xla_dense`` backend, with the reference's 4x factor and its 0.6-1.6
kv-scaling band. The reference also bounds the HLO cost model's bytes;
the flop counter counts no bytes, so those asserts have no counterpart
here. The reference's two ``roofline.analysis`` tests wait for the
dry-run tools (ROADMAP.md section 1, item 11).
"""
from __future__ import annotations

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.autotune as jat
import repro.roofline.hardware as jhw
from repro.attention import AttnCall as JCall
from repro.attention import DraftProfile as JDraft
from repro.core.config import HDPConfig as JHDP
from repro_torch.attention import (AttnCall, AttnSpec, DraftProfile,
                                   attention)
from repro_torch.attention.registry import (BACKEND_ENV, POLICY_ENV,
                                            effective_policy, resolve_backend)
from repro_torch.autotune import (OP_WEIGHT, CallSig, SparsityEstimate,
                                  SpecConfig, SpecController, Tuner,
                                  call_signature, crossover_table, predict,
                                  predict_engine_step, reset_default_tuner)
from repro_torch.autotune.tuner import TUNER_CACHE_ENV, default_tuner
from repro_torch.core.config import HDPConfig
from repro_torch.roofline import hardware as thw
from repro_torch.roofline.hardware import (H100_SXM, HOST_CPU,
                                           detect_profile, get_profile)

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

B, N, G, HD = 1, 2, 2, 8
HDP_KW = dict(block_q=4, block_k=4, rho_b=0.5, tau_h=0.0,
              normalize_head_score=True, calib="max")
HDP = HDPConfig(**HDP_KW)
BACKENDS = tuple(OP_WEIGHT) + ("not_a_backend",)


@pytest.fixture(autouse=True)
def _fresh_default_tuner():
    """Process-default tuner state must not leak between tests."""
    reset_default_tuner()
    jat.reset_default_tuner()
    yield
    reset_default_tuner()
    jat.reset_default_tuner()


def _decode_sig(kv=256, hdp=False, **kw):
    base = dict(mode="decode", layout="dense", batch=B, n_kv_heads=N,
                group=G, sq=1, hd=HD, kv_len=kv, hdp=hdp)
    if hdp:
        base.update(block_q=4, block_k=4)
    base.update(kw)
    return CallSig(**base)


def _jsig(sig: CallSig):
    return jat.CallSig(**dataclasses.asdict(sig))


def _jhw(hw):
    """The reference's HardwareProfile with the port profile's fields."""
    return jhw.HardwareProfile(**dataclasses.asdict(hw))


def _sweep():
    """CallSigs across modes, layouts, HDP, drafts, verify, dtypes, tp."""
    sigs = []
    for kv in (64, 1000, 8192):
        for hdp in (False, True):
            sigs.append(_decode_sig(kv=kv, hdp=hdp))
            sigs.append(_decode_sig(kv=kv, hdp=hdp, mode="prefill", sq=kv,
                                    q_itemsize=2, kv_itemsize=2))
            sigs.append(_decode_sig(kv=kv, hdp=hdp, mode="prefill", sq=16,
                                    causal=False, window=32))
        for draft in ("", "scout", "int", "approx"):
            sigs.append(_decode_sig(kv=kv, hdp=True, layout="paged",
                                    page_size=16, kv_itemsize=1,
                                    per_slot=True, draft=draft, batch=8,
                                    group=6, hd=128))
        sigs.append(_decode_sig(kv=kv, hdp=True, layout="paged",
                                page_size=16, per_slot=True, verify=True,
                                sq=4, tp=2))
    return sigs


# --------------------------------------------------------------- hardware
class TestHardware:
    def test_get_profile(self):
        assert get_profile("h100_sxm") is H100_SXM
        assert get_profile("host_cpu") is HOST_CPU
        with pytest.raises(KeyError):
            get_profile("tpu_v5e")

    def test_detect_profile_matches_backend(self, monkeypatch):
        prof = detect_profile()
        expect = H100_SXM if torch.cuda.is_available() else HOST_CPU
        assert prof is expect
        assert detect_profile("cpu") is HOST_CPU
        assert detect_profile(torch.device("cpu")) is HOST_CPU
        # a card keys on its name: the H100's gets its profile, any other
        # raises naming the card, never the CPU's profile
        for name, want in (("NVIDIA H100 80GB HBM3", H100_SXM),
                           ("Some Other GPU", None)):
            monkeypatch.setattr(torch.cuda, "get_device_name",
                                lambda dev=None, _n=name: _n)
            if want is None:
                with pytest.raises(ValueError, match="Some Other GPU"):
                    detect_profile("cuda")
            else:
                assert detect_profile("cuda") is want

    def test_host_cpu_is_the_references(self):
        assert dataclasses.asdict(HOST_CPU) == \
            dataclasses.asdict(jhw.HOST_CPU)
        assert [f.name for f in dataclasses.fields(thw.HardwareProfile)] \
            == [f.name for f in dataclasses.fields(jhw.HardwareProfile)]

    def test_h100_profile(self):
        assert H100_SXM.pallas_native and H100_SXM.interpret_slowdown == 1.0
        assert H100_SXM.peak_flops == 989e12 and H100_SXM.hbm_bw == 3.35e12
        # no TPU profile or constant in the port
        assert set(thw.PROFILES) == {"h100_sxm", "host_cpu"}
        tpu = dataclasses.asdict(jhw.TPU_V5E)
        for f in ("peak_flops", "hbm_bw", "ici_bw", "mem_bytes",
                  "dispatch_s", "op_overhead_s"):
            assert getattr(H100_SXM, f) != tpu[f], f


# ---------------------------------------------------------------- CallSig
class TestCallSig:
    def test_dense_signature_from_live_shapes(self):
        call = AttnCall(mode="decode", layout="dense")
        q = torch.zeros((B, N, G, 1, HD))
        k = torch.zeros((B, 32, N, HD))
        sig = call_signature(call, q, k=k)
        assert (sig.batch, sig.n_kv_heads, sig.group) == (B, N, G)
        assert (sig.sq, sig.kv_len, sig.hd) == (1, 32, HD)
        assert sig.heads == N * G
        assert not sig.hdp and sig.page_size == 0

    def test_paged_signature_derives_extent_from_table(self):
        call = AttnCall(mode="decode", layout="paged", hdp=HDP,
                        per_slot=True)
        q = torch.zeros((B, N, G, 1, HD))
        cache = {"k_pages": torch.zeros((9, 4, N, HD))}
        table = torch.ones((B, 6), dtype=torch.int32)
        sig = call_signature(call, q, cache=cache, page_table=table)
        assert sig.kv_len == 6 * 4 and sig.page_size == 4
        assert sig.hdp and (sig.block_q, sig.block_k) == (4, 4)
        assert sig.per_slot

    def test_key_distinguishes_and_roundtrips(self):
        a, b = _decode_sig(kv=128), _decode_sig(kv=256)
        assert a.key() != b.key()
        assert a.key() == _decode_sig(kv=128).key()
        assert isinstance(hash(a), int)  # usable as a dict key directly

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_keys_equal_the_references(self, dt, layout):
        """torch and jnp tensors of the same shapes and dtypes give equal
        signature keys, in every call shape of the serving engine."""
        for kw in (dict(mode="decode", per_slot=True),
                   dict(mode="decode", per_slot=True, verify=True),
                   dict(mode="decode", per_slot=True,
                        draft=DraftProfile(scores="int")),
                   dict(mode="prefill")):
            if layout == "paged" and kw["mode"] == "prefill":
                continue
            jkw = dict(kw)
            if "draft" in jkw:
                jkw["draft"] = JDraft(scores="int")
            call = AttnCall(layout=layout, hdp=HDP, **kw)
            jcall = JCall(layout=layout, hdp=JHDP(**HDP_KW), **jkw)
            sq = 16 if kw["mode"] == "prefill" else (3 if "verify" in kw
                                                     else 1)
            q = np.zeros((2, N, G, sq, HD), np.float32)
            k = np.zeros((2, 24, N, HD), np.float32)
            tq = torch.from_numpy(q).to(getattr(torch, dt))
            jq = jnp.asarray(q, dtype=getattr(jnp, dt))
            if layout == "paged":
                pages = np.zeros((7, 4, N, HD), np.int8)
                table = np.zeros((2, 3), np.int32)
                got = call_signature(
                    call, tq, cache={"k_pages": torch.from_numpy(pages)},
                    page_table=torch.from_numpy(table))
                want = jat.call_signature(
                    jcall, jq, cache={"k_pages": jnp.asarray(pages)},
                    page_table=jnp.asarray(table))
            else:
                got = call_signature(call, tq,
                                     k=torch.from_numpy(k).to(tq.dtype))
                want = jat.call_signature(jcall, jq,
                                          k=jnp.asarray(k, dtype=jq.dtype))
            assert got.key() == want.key(), kw


# -------------------------------------------------------------- predictor
class TestPredict:
    def test_monotonic_in_kv_len(self):
        ts = [predict("xla_dense", _decode_sig(kv=kv),
                      HOST_CPU).step_time(HOST_CPU)
              for kv in (128, 512, 2048)]
        assert ts[0] < ts[1] < ts[2]

    def test_dense_hdp_costs_more_than_dense(self):
        # dense-layout HDP streams every byte AND quantizes: pruning can
        # only win on the paged fetch-upon-mask path
        sig = _decode_sig(kv=1024, hdp=True)
        t_hdp = predict("xla_hdp", sig, H100_SXM).step_time(H100_SXM)
        t_dense = predict("xla_dense", _decode_sig(kv=1024),
                          H100_SXM).step_time(H100_SXM)
        assert t_hdp > t_dense

    def test_sparsity_shrinks_paged_hdp_bytes(self):
        sig = _decode_sig(kv=4096, hdp=True, layout="paged", page_size=16,
                          per_slot=True)
        lo = predict("paged_hdp_decode", sig, H100_SXM,
                     SparsityEstimate(page=0.0))
        hi = predict("paged_hdp_decode", sig, H100_SXM,
                     SparsityEstimate(page=0.9))
        assert hi.hbm_bytes < lo.hbm_bytes
        assert hi.step_time(H100_SXM) < lo.step_time(H100_SXM)

    def test_plain_kernel_versions_never_win_on_the_cpu(self):
        sig = _decode_sig(kv=4096)
        t_kernel = predict("pallas_flash", sig, HOST_CPU)
        t_dense = predict("xla_dense", sig, HOST_CPU)
        assert t_kernel.interpreted and not t_dense.interpreted
        assert t_kernel.step_time(HOST_CPU) > t_dense.step_time(HOST_CPU)
        # ...but the kernel running natively is competitive on the card
        assert not predict("pallas_flash", sig, H100_SXM).interpreted

    def test_prior_and_clamp(self):
        assert SparsityEstimate.prior(_decode_sig()) == SparsityEstimate()
        p = SparsityEstimate.prior(_decode_sig(hdp=True))
        assert p.block > 0 and p.page > 0
        c = SparsityEstimate(block=1.5, head=-0.3, page=0.5).clamped()
        assert c.block == 0.999 and c.head == 0.0 and c.page == 0.5

    def test_engine_step_dominated_by_weights(self):
        est = predict("xla_dense", _decode_sig(kv=256), H100_SXM)
        t = predict_engine_step(1_000_000_000, 4, 24, est, H100_SXM)
        assert t > 1_000_000_000 * 4 / H100_SXM.hbm_bw  # weight-read floor
        assert t > 24 * est.step_time(H100_SXM)

    @pytest.mark.parametrize("hw", [HOST_CPU, H100_SXM],
                             ids=["host_cpu", "h100_sxm"])
    def test_predictions_equal_the_references_bit_for_bit(self, hw):
        jh = _jhw(hw)
        sps = (None, SparsityEstimate(0.3, 0.1, 0.45),
               SparsityEstimate(1.5, -0.2, 0.999))
        n = 0
        for sig in _sweep():
            for name in BACKENDS:
                for sp in sps:
                    jsp = None if sp is None else \
                        jat.SparsityEstimate(sp.block, sp.head, sp.page)
                    got = predict(name, sig, hw, sp)
                    want = jat.predict(name, _jsig(sig), jh, jsp)
                    assert (got.flops, got.hbm_bytes, got.overhead_s,
                            got.interpreted) == (
                        want.flops, want.hbm_bytes, want.overhead_s,
                        want.interpreted), (name, sig)
                    assert got.step_time(hw) == want.step_time(jh)
                    n += 1
            est = predict("paged_hdp_decode", sig, hw)
            assert predict_engine_step(1_543_714_304, 8, 28, est, hw) == \
                jat.predict_engine_step(
                    1_543_714_304, 8, 28,
                    jat.predict("paged_hdp_decode", _jsig(sig), jh), jh)
        assert n > 500
        assert OP_WEIGHT == jat.OP_WEIGHT


# ---------------------------------------- predictor vs the flop counter
class TestFlopAgreement:
    """The analytic model against the FLOPs torch counts for the port's
    ``xla_dense`` backend (matmuls only: softmax and masking are not
    counted). Absolute agreement is loose, the kv_len *scaling* — the
    signal backend ranking rides on — must be tight."""

    SPEC = AttnSpec(backend="xla_dense", policy="static")

    def _counted(self, kv, sq=1):
        call = AttnCall(mode="decode" if sq == 1 else "prefill",
                        layout="dense")
        q = torch.zeros((B, N, G, sq, HD))
        k = torch.zeros((B, kv, N, HD))
        v = torch.zeros((B, kv, N, HD))
        with FlopCounterMode(display=False) as fc:
            attention(q, k, v, call, spec=self.SPEC)
        return fc.get_total_flops()

    def test_decode_flops_within_factor(self):
        for kv in (128, 512):
            counted = self._counted(kv)
            est = predict("xla_dense", _decode_sig(kv=kv), HOST_CPU)
            assert counted > 0
            assert est.flops / counted < 4.0, (kv, est.flops, counted)
            assert counted / est.flops < 4.0, (kv, est.flops, counted)

    def test_decode_kv_scaling_tight(self):
        ratio = self._counted(512) / self._counted(128)
        pred_ratio = predict("xla_dense", _decode_sig(kv=512),
                             HOST_CPU).flops / \
            predict("xla_dense", _decode_sig(kv=128), HOST_CPU).flops
        assert 0.6 < ratio / pred_ratio < 1.6, (ratio, pred_ratio)

    def test_prefill_flops_within_factor(self):
        kv = 64
        counted = self._counted(kv, sq=kv)
        sig = _decode_sig(kv=kv, mode="prefill", sq=kv)
        est = predict("xla_dense", sig, HOST_CPU)
        # predictor prices the causal triangle (kv/2); the backend
        # computes the full rectangle then masks — expect ~2x, gate at 4x
        assert est.flops / counted < 4.0
        assert counted / est.flops < 4.0


# -------------------------------------------------------------- crossover
class TestCrossover:
    SIG = CallSig(mode="decode", layout="paged", batch=4, n_kv_heads=2,
                  group=6, sq=1, hd=64, kv_len=0, page_size=16, hdp=True,
                  block_q=4, block_k=4, per_slot=True)

    def test_table_shape_and_fields(self):
        rows = crossover_table(self.SIG, H100_SXM, (128, 8192), (0.0, 0.75))
        assert len(rows) == 4
        for r in rows:
            assert {"kv_len", "page_sparsity", "t_hdp_s", "t_dense_s",
                    "winner"} <= set(r)
            assert r["winner"] in ("hdp", "dense")

    @pytest.mark.parametrize("hw", [H100_SXM, HOST_CPU],
                             ids=["h100_sxm", "host_cpu"])
    def test_winner_flips_with_sparsity_times_kv(self, hw):
        rows = crossover_table(self.SIG, hw, (128, 65536), (0.0, 0.9))
        by = {(r["kv_len"], r["page_sparsity"]): r["winner"] for r in rows}
        # short + dense-ish: the sparse pipeline's overhead loses
        assert by[(128, 0.0)] == "dense"
        # long + very sparse: fetch-upon-mask wins
        assert by[(65536, 0.9)] == "hdp"

    @pytest.mark.parametrize("hw", [HOST_CPU, H100_SXM],
                             ids=["host_cpu", "h100_sxm"])
    def test_rows_equal_the_references(self, hw):
        kvs, sps = (16, 128, 1000, 8192, 65536), (0.0, 0.25, 0.5, 0.9, 0.99)
        for sig in (self.SIG, dataclasses.replace(self.SIG, kv_itemsize=1),
                    dataclasses.replace(self.SIG, sq=4, verify=True)):
            assert crossover_table(sig, hw, kvs, sps) == \
                jat.crossover_table(_jsig(sig), _jhw(hw), kvs, sps)


# ------------------------------------------------------------------ tuner
def _cands(*names):
    return [types.SimpleNamespace(name=n) for n in names]


class TestTuner:
    CALL = AttnCall(mode="decode", layout="dense")

    def test_choose_picks_predicted_fastest(self):
        t = Tuner(hw=HOST_CPU)
        sig = _decode_sig(kv=512)
        best = t.choose(self.CALL, sig, _cands("xla_dense", "reference"))
        assert best.name == "xla_dense"  # oracle is priced out
        assert t.misses == 1 and t.hits == 0
        assert t.decision[sig.key()] == "xla_dense"
        assert not t.pending  # reference is nowhere near the margin

    def test_ambiguity_registers_pending_and_probe_flips(self):
        t = Tuner(hw=HOST_CPU, margin=1e9)  # everything is ambiguous
        sig = _decode_sig(kv=256)
        t.choose(self.CALL, sig, _cands("xla_dense", "reference"))
        assert sig.key() in t.pending
        t._probe = lambda call, sig, names: "reference"
        assert t.flush_probes() is True  # measured winner != prediction
        assert t.decision[sig.key()] == "reference"
        assert t.measured[sig.key()] == "reference"
        assert t.probes == 1 and not t.pending
        # next sighting is a measured-cache hit
        best = t.choose(self.CALL, sig, _cands("xla_dense", "reference"))
        assert best.name == "reference" and t.hits == 1

    def test_probe_failure_keeps_prediction(self):
        t = Tuner(hw=HOST_CPU, margin=1e9)
        sig = _decode_sig(kv=256)
        t.choose(self.CALL, sig, _cands("xla_dense", "reference"))

        def boom(call, sig, names):
            raise RuntimeError("probe exploded")

        t._probe = boom
        assert t.flush_probes() is False
        assert not t.pending  # never re-tried
        assert t.decision[sig.key()] == "xla_dense"
        assert t.flush_probes() is False  # idempotent when drained

    def test_real_probe_on_paged_hdp_call(self):
        # one end-to-end probe: synthetic inputs + an eager backend run
        call = AttnCall(mode="decode", layout="paged", hdp=HDP,
                        per_slot=True)
        sig = CallSig(mode="decode", layout="paged", batch=1, n_kv_heads=N,
                      group=G, sq=1, hd=HD, kv_len=8, page_size=4,
                      hdp=True, block_q=4, block_k=4, per_slot=True)
        t = Tuner(hw=HOST_CPU, probe_reps=1)
        assert t._probe(call, sig, ("paged_hdp_decode",)) \
            == "paged_hdp_decode"
        assert t.device.type == "cpu"
        assert set(t.probe_times[sig.key()]) == {"paged_hdp_decode"}

    def test_probe_interleaves_candidates(self, monkeypatch):
        """After one untimed run each, the candidates take turns rep by
        rep, so that a drift of the host's speed weighs on each alike;
        a candidate's time is the minimum of its timed reps."""
        from repro_torch.attention import registry as attn_registry
        from repro_torch.autotune import tuner as tuner_mod
        order, now = [], [0.0]
        cost = {"a": iter([0.0, 5.0, 3.0, 4.0]),
                "b": iter([0.0, 2.0, 6.0, 1.0])}

        class Fake:
            def __init__(self, name):
                self.name = name

            def run(self, q, *a, **kw):
                order.append(self.name)
                now[0] += next(cost[self.name])
                return (q,)

        monkeypatch.setattr(attn_registry, "get_backend", Fake)
        monkeypatch.setattr(tuner_mod.time, "perf_counter", lambda: now[0])
        call = AttnCall(mode="decode", layout="paged", hdp=HDP,
                        per_slot=True)
        sig = CallSig(mode="decode", layout="paged", batch=1, n_kv_heads=N,
                      group=G, sq=1, hd=HD, kv_len=8, page_size=4,
                      hdp=True, block_q=4, block_k=4, per_slot=True)
        t = Tuner(hw=HOST_CPU, probe_reps=3)
        assert t._probe(call, sig, ("a", "b")) == "b"
        assert order == ["a", "b"] + ["a", "b"] * 3
        assert t.probe_times[sig.key()] == {"a": 3.0, "b": 1.0}

    def test_real_probe_times_both_candidates(self):
        """The top-2 of a paged decode signature under the card's
        profile (the FUM kernel's backend and the block route), probed
        on the CPU through their plain versions, and a verify and a
        scout draft signature: every candidate runs and is timed."""
        hw = dataclasses.replace(H100_SXM, pallas_native=False,
                                 interpret_slowdown=1.0)
        for kw in (dict(), dict(verify=True, sq=3),
                   dict(draft=DraftProfile())):
            call = AttnCall(mode="decode", layout="paged", hdp=HDP,
                            per_slot=True, **{k: v for k, v in kw.items()
                                              if k != "sq"})
            sig = CallSig(mode="decode", layout="paged", batch=2,
                          n_kv_heads=N, group=G, sq=kw.get("sq", 1), hd=HD,
                          kv_len=16, page_size=4, hdp=True, block_q=4,
                          block_k=4, per_slot=True,
                          draft="scout" if "draft" in kw else "",
                          verify=kw.get("verify", False))
            names = ("paged_hdp_decode",) if "draft" in kw else \
                ("pallas_paged_decode", "pallas_hdp_block") if not \
                kw.get("verify") else ("pallas_paged_decode",
                                       "paged_hdp_decode")
            t = Tuner(hw=hw, probe_reps=1)
            assert t._probe(call, sig, names) in names
            assert set(t.probe_times[sig.key()]) == set(names)

    def test_synthetic_inputs_equal_the_references(self):
        from repro.autotune.tuner import _synthetic_inputs as j_inputs
        from repro_torch.autotune.tuner import _synthetic_inputs
        for layout, per_slot in (("dense", False), ("paged", True)):
            call = AttnCall(mode="decode", layout=layout, hdp=HDP,
                            per_slot=per_slot, draft=DraftProfile())
            jcall = JCall(mode="decode", layout=layout,
                          hdp=JHDP(**HDP_KW), per_slot=per_slot,
                          draft=JDraft())
            sig = _decode_sig(kv=16, hdp=True, layout=layout, batch=2,
                              page_size=4 if layout == "paged" else 0,
                              per_slot=per_slot, draft="scout")
            got = _synthetic_inputs(call, sig)
            want = j_inputs(jcall, _jsig(sig))
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                elif isinstance(w, dict):
                    assert set(g) == set(w)
                    for key in w:
                        np.testing.assert_array_equal(g[key].numpy(),
                                                      np.asarray(w[key]))
                else:
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_save_load_roundtrip_warm_start(self, tmp_path):
        path = str(tmp_path / "tuner.json")
        t = Tuner(hw=HOST_CPU, margin=1e9)
        sig = _decode_sig(kv=256)
        t.choose(self.CALL, sig, _cands("xla_dense", "reference"))
        t._probe = lambda call, sig, names: "xla_dense"
        t.flush_probes()
        t.save(path)

        warm = Tuner(hw=HOST_CPU, cache_path=path)
        assert warm.measured == {sig.key(): "xla_dense"}
        warm.choose(self.CALL, sig, _cands("xla_dense", "reference"))
        assert warm.hits == 1 and warm.probes == 0 and not warm.pending

    def test_load_rejects_other_hardware(self, tmp_path):
        path = str(tmp_path / "tuner.json")
        t = Tuner(hw=HOST_CPU)
        t.measured["x"] = "xla_dense"
        t.save(path)
        other = Tuner(hw=H100_SXM)
        assert other.load(path) is False and not other.measured

    def test_caches_load_across_packages(self, tmp_path):
        sig = _decode_sig(kv=256)
        for i, (src_cls, dst_cls) in enumerate(
                ((Tuner, jat.Tuner), (jat.Tuner, Tuner))):
            path = str(tmp_path / f"tuner{i}.json")
            hw = HOST_CPU if src_cls is Tuner else jhw.HOST_CPU
            src = src_cls(hw=hw)
            src.measured[sig.key()] = "reference"
            src.save(path)
            dst_hw = HOST_CPU if dst_cls is Tuner else jhw.HOST_CPU
            dst = dst_cls(hw=dst_hw, cache_path=path)
            assert dst.measured == {sig.key(): "reference"}
            with open(path) as f:
                text = f.read()
            path2 = str(tmp_path / f"again{i}.json")
            dst.save(path2)
            with open(path2) as f:
                assert f.read() == text

    def test_default_tuner_honors_cache_env(self, tmp_path, monkeypatch):
        path = str(tmp_path / "warm.json")
        src = Tuner()  # detected profile — what default_tuner will use
        src.measured["k"] = "xla_dense"
        src.save(path)
        monkeypatch.setenv(TUNER_CACHE_ENV, path)
        reset_default_tuner()
        assert default_tuner().measured == {"k": "xla_dense"}
        reset_default_tuner()
        assert default_tuner("cpu").hw is HOST_CPU

    def test_decisions_deterministic_across_tuners(self):
        sigs = [_decode_sig(kv=kv, hdp=h)
                for kv in (64, 1024) for h in (False, True)]
        runs = []
        for _ in range(2):
            t = Tuner(hw=HOST_CPU)
            for sig in sigs:
                t.choose(self.CALL, sig,
                         _cands("xla_dense", "xla_hdp", "reference"))
            runs.append(dict(t.decision))
        assert runs[0] == runs[1]

    @pytest.mark.parametrize("margin", [0.25, 1.0, 1e9])
    @pytest.mark.parametrize("hw", [HOST_CPU, H100_SXM],
                             ids=["host_cpu", "h100_sxm"])
    def test_choose_equals_the_references(self, hw, margin):
        """Over the sweep, with measured sparsity folded in half way,
        both packages' tuners leave equal decisions, pending probes,
        estimates and counters."""
        t, j = Tuner(hw=hw, margin=margin), jat.Tuner(hw=_jhw(hw),
                                                      margin=margin)
        cand_sets = (BACKENDS[:-1], ("xla_dense", "reference"),
                     ("paged_hdp_decode", "pallas_hdp_block",
                      "pallas_paged_decode", "reference"),
                     ("xla_hdp", "pallas_hdp_block"))
        sigs = _sweep()
        for i, sig in enumerate(sigs):
            if i == len(sigs) // 2:
                t.observe_sparsity(0.3, 0.1, 0.6)
                j.observe_sparsity(0.3, 0.1, 0.6)
            for names in cand_sets:
                got = t.choose(self.CALL, sig, _cands(*names))
                want = j.choose(self.CALL, _jsig(sig), _cands(*names))
                assert got.name == want.name, (sig, names)
        assert t.decision == j.decision
        assert {k: (v[1].key(), v[2]) for k, v in t.pending.items()} == \
            {k: (v[1].key(), v[2]) for k, v in j.pending.items()}
        if margin == 1e9:
            assert t.pending
        assert t.stats() == j.stats()
        for key, ests in t.estimates.items():
            assert {n: (e.flops, e.hbm_bytes, e.overhead_s)
                    for n, e in ests.items()} == \
                {n: (e.flops, e.hbm_bytes, e.overhead_s)
                 for n, e in j.estimates[key].items()}

    def test_decision_for_matches_phase(self):
        t = Tuner(hw=HOST_CPU)
        t.choose(self.CALL, _decode_sig(kv=512),
                 _cands("xla_dense", "reference"))
        assert t.decision_for(self.CALL) == "xla_dense"
        assert t.decision_for(AttnCall(mode="prefill",
                                       layout="dense")) is None
        name, est = t.estimate_for(self.CALL)
        assert name == "xla_dense" and est.flops > 0

    def test_sparsity_ema(self):
        t = Tuner(hw=HOST_CPU)
        t.observe_sparsity(0.4, 0.1, 0.6)
        t.observe_sparsity(0.8, 0.1, 0.2)
        sp = t.sparsity_for(_decode_sig(hdp=True))
        assert 0.4 < sp.block < 0.8 and 0.2 < sp.page < 0.6
        # non-HDP signatures never see sparsity discounts
        assert t.sparsity_for(_decode_sig()) == SparsityEstimate()


# ----------------------------------------------------------------- policy
class TestPolicy:
    def test_explicit_policy_pins(self, monkeypatch):
        monkeypatch.setenv(POLICY_ENV, "cost")
        assert effective_policy(AttnSpec(policy="static")) == "static"
        assert effective_policy(AttnSpec(policy="cost")) == "cost"

    def test_auto_policy_reads_env(self, monkeypatch):
        monkeypatch.delenv(POLICY_ENV, raising=False)
        assert effective_policy(AttnSpec()) == "static"
        monkeypatch.setenv(POLICY_ENV, "cost")
        assert effective_policy(AttnSpec()) == "cost"

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError):
            AttnSpec(policy="fastest")

    def test_backend_env_overrides_cost_policy(self, monkeypatch):
        # REPRO_ATTN_BACKEND pins an explicit backend: the oracle leg
        # must win over cost ranking or it stops testing the oracle
        monkeypatch.setenv(BACKEND_ENV, "reference")
        call = AttnCall(mode="decode", layout="dense")
        b = resolve_backend(call, AttnSpec(policy="cost"),
                            sig=_decode_sig(kv=128))
        assert b.name == "reference"

    def test_cost_policy_resolves_through_tuner(self, monkeypatch):
        monkeypatch.delenv(BACKEND_ENV, raising=False)
        t = Tuner(hw=HOST_CPU)
        call = AttnCall(mode="decode", layout="dense")
        b = resolve_backend(call, AttnSpec(policy="cost"),
                            sig=_decode_sig(kv=128), tuner=t)
        assert b.name == "xla_dense"
        assert t.misses == 1  # the tuner, not the static order, answered

    def test_dispatch_consults_the_default_tuner(self, monkeypatch):
        """``attention()`` under the cost policy builds the call's
        signature and asks the process-default tuner, once per call."""
        monkeypatch.delenv(BACKEND_ENV, raising=False)
        call = AttnCall(mode="decode", layout="dense")
        q = torch.zeros((B, N, G, 1, HD))
        k = torch.zeros((B, 32, N, HD))
        for _ in range(3):
            attention(q, k, k, call, spec=AttnSpec(policy="cost"),
                      q_pos=torch.tensor([31]))
        t = default_tuner()
        assert t.misses == 3 and list(t.decision.values()) == ["xla_dense"]


# ---------------------------------------------------------- SpecController
class TestSpecController:
    BASE = DraftProfile(scores="scout")

    def _ctl(self, **kw):
        return SpecController(self.BASE, HDP, SpecConfig(**kw))

    def test_optimistic_start_drafts_full_length(self):
        k, profile = self._ctl(k_max=4).plan()
        assert k == 4 and profile.rho_b == pytest.approx(0.6)
        assert profile.tau_h == pytest.approx(0.05)
        assert profile.scores == "scout"  # pool layout never varies

    def test_collapse_walks_down_to_k1_conservative(self):
        ctl = self._ctl(k_max=4)
        for _ in range(12):
            ctl.update(0, 3)
        assert ctl.ema < ctl.cfg.conservative_below
        k, profile = ctl.plan()
        assert k == 1
        assert profile is ctl.conservative
        assert profile.rho_b is None and profile.tau_h is None

    def test_recovery_raises_k_again(self):
        ctl = self._ctl(k_max=4)
        for _ in range(12):
            ctl.update(0, 3)
        for _ in range(20):
            ctl.update(3, 3)
        k, profile = ctl.plan()
        assert k == 4 and profile is ctl.aggressive

    def test_zero_draft_rounds_leave_ema_untouched(self):
        ctl = self._ctl()
        ema0 = ctl.ema
        ctl.update(0, 0)
        ctl.update(5, -1)
        assert ctl.ema == ema0 and ctl.rounds == 2
        assert ctl.drafted_total == 0

    def test_aggressive_rho_clamped(self):
        hot = HDP.replace(rho_b=0.93)
        ctl = SpecController(DraftProfile(), hot, SpecConfig())
        assert ctl.aggressive.rho_b == pytest.approx(0.95)

    def test_base_overrides_beat_hdp_fallback(self):
        ctl = SpecController(DraftProfile(rho_b=0.2, tau_h=0.1), HDP,
                             SpecConfig(rho_step=0.1, tau_step=0.05))
        assert ctl.aggressive.rho_b == pytest.approx(0.3)
        assert ctl.aggressive.tau_h == pytest.approx(0.15)

    def test_summary_and_rates(self):
        ctl = self._ctl()
        ctl.plan()
        ctl.update(2, 3)
        s = ctl.summary()
        assert s["rounds"] == 1 and s["drafted"] == 3 and s["accepted"] == 2
        assert s["acceptance_rate"] == pytest.approx(2 / 3)
        assert s["draft_len_mean"] >= 1.0

    def test_config_validation(self):
        with pytest.raises(ValueError):
            SpecConfig(k_min=3, k_max=2)
        with pytest.raises(ValueError):
            SpecConfig(k_min=0)
        with pytest.raises(ValueError):
            SpecConfig(beta=1.0)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("k_max", [2, 4, 8])
    def test_plans_equal_the_references(self, seed, k_max):
        """One seeded accept stream through both packages' controllers
        plans the same (k, tier) sequence and ends with equal
        summaries."""
        base = DraftProfile(rho_b=0.3) if seed == 2 else self.BASE
        jbase = JDraft(rho_b=0.3) if seed == 2 else JDraft(scores="scout")
        t = SpecController(base, HDP, SpecConfig(k_max=k_max))
        j = jat.SpecController(jbase, JHDP(**HDP_KW),
                               jat.SpecConfig(k_max=k_max))

        def tier(ctl, p):
            return next(n for n in ("aggressive", "base", "conservative")
                        if getattr(ctl, n) is p)

        rng = np.random.default_rng(seed)
        # acceptance that collapses, then recovers, with noise
        rates = np.concatenate([np.full(15, 0.9), np.full(15, 0.05),
                                np.full(20, 0.95)])
        for r in rates:
            (kt, pt), (kj, pj) = t.plan(), j.plan()
            assert (kt, tier(t, pt)) == (kj, tier(j, pj))
            assert (pt.rho_b, pt.tau_h, pt.scores) == \
                (pj.rho_b, pj.tau_h, pj.scores)
            n_act = int(rng.integers(1, 9))
            drafted = (kt - 1) * n_act
            acc = int(rng.binomial(drafted, r)) if drafted else 0
            t.update(acc, drafted)
            j.update(acc, drafted)
        assert t.summary() == j.summary()
