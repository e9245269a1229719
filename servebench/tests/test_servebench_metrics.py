"""Every metric reader's arithmetic on synthetic counters, and the
profiler slice's reduction on a synthetic trace."""
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import peaks, profiling
from servebench.drive import Record, Window
from servebench.run import metric_reader

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parents[1]


def res(ttft, tpot, wait, n, status="ok"):
    return types.SimpleNamespace(ttft_s=ttft, tpot_s=tpot, queue_wait_s=wait,
                                 tokens=[1] * n, status=status)


def window(trace=None):
    m = {"d_model": 8, "n_heads": 2, "n_kv_heads": 2, "head_dim": 4,
         "d_ff": 16, "vocab_size": 32, "n_layers": 2, "n_experts": 0,
         "n_experts_active": 0}
    recs = {}
    for i in range(20):
        r = Record(i, i % 4, np.zeros(100 + i, np.int64), 10, 0.0,
                   counted=i < 18, owners=[0] if i % 2 else [],
                   t_admit=5.0 if i < 16 else 50.0)
        r.result = res(0.1 * (i + 1), 0.01 * (i + 1), 0.02, 10)
        recs[i] = r
    recs[17].result = res(None, None, None, 0, status="error")
    m0 = {"tokens_out": 100, "prefill_s": 1.0, "decode_s": 2.0,
          "decode_steps": 10, "page_sparsity": 1.0, "page_samples": 4}
    m1 = {"tokens_out": 600, "prefill_s": 3.0, "decode_s": 6.0,
          "decode_steps": 50, "page_sparsity": 13.0, "page_samples": 24}
    w = Window(10.0, 30.0, m0, m1, 1000, 1000 + 8 * 128, recs, 0.0, 10.0,
               128, {"model": m}, trace=trace, kind="NVIDIA H100 80GB HBM3")
    return w


def read(name, w):
    return metric_reader(name)(w)


def test_end_to_end():
    w = window()
    assert read("output_tok_s", w) == pytest.approx(50.0)
    assert read("setup_s", w) == 30.0
    # 18 counted, one failed (infinite): percentiles by linear interpolation,
    # and one that reaches towards the failed request is infinite, not NaN
    assert read("ttft_p99_s", w) == math.inf
    assert read("tpot_p95_ms", w) == np.percentile(
        [10 * (i + 1) for i in range(17)] + [math.inf], 95)
    w.records[17].result = w.records[16].result
    assert read("ttft_p99_s", w) == np.percentile(
        [0.1 * (i + 1) for i in range(17)] + [1.7], 99)


def test_per_layer_counters():
    w = window()
    assert read("sched_queue_wait_ms", w) == pytest.approx(20.0)
    admitted = [r for r in w.records.values() if r.t_admit == 5.0]
    prompt = sum(len(r.prompt) for r in admitted)
    assert read("prefix_hit_share", w) == pytest.approx(100 * 1024 / prompt)
    real = prompt - 128 * sum(1 for r in admitted if r.owners)
    assert read("prefill_ms_per_ktok", w) == pytest.approx(2000 / (real / 1e3))
    assert read("decode_step_ms", w) == pytest.approx(100.0)
    assert read("hdp_page_sparsity", w) == pytest.approx(60.0)


def test_trace_readers_and_silence_without_a_trace():
    w = window()
    for name in ("fum_ms_per_step", "device_idle_share"):
        assert read(name, w) is None
    w = window({"decode_steps": 40, "fum_s": 0.2, "window_s": 2.0,
                "busy_s": 1.5})
    assert read("fum_ms_per_step", w) == pytest.approx(5.0)
    assert read("device_idle_share", w) == pytest.approx(25.0)


def test_mfu():
    w = window()
    m = w.conf["model"]
    flops = sum(peaks.prompt_flops(m, w.hit_tokens(r), len(r.prompt))
                for r in w.admitted)
    ctx = [len(r.prompt) + i for r in w.counted if r.result is not None
           for i in range(len(r.result.tokens))]
    flops += 500 * peaks.token_flops(m, sum(ctx) / len(ctx))
    assert read("mfu", w) == pytest.approx(100 * flops / (10 * 989e12))
    w.kind = "some other card"
    assert read("mfu", w) is None


def test_model_flops():
    m = {"d_model": 2048, "n_heads": 16, "n_kv_heads": 16, "head_dim": 0,
         "d_ff": 1024, "vocab_size": 50304, "n_layers": 16,
         "n_experts": 64, "n_experts_active": 8}
    # olmoe's active parameters, the embedding lookup left out
    want = 16 * (4 * 2048 * 2048 + 8 * 3 * 2048 * 1024 + 2048 * 64) \
        + 2048 * 50304
    assert peaks.active_params(m) == want
    assert peaks.prompt_flops(m, 0, 3) == pytest.approx(
        sum(peaks.token_flops(m, c) for c in (1, 2, 3)))


class _Ev:
    def __init__(self, name, a, b, dev):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU


def test_profile_summary():
    evs = [_Ev("fum_decode_kernel", 0, 100, True),
           _Ev("ampere_bf16_gemm", 50, 300, True),
           _Ev("elementwise_kernel<x>", 1000, 1500, True),
           _Ev("vectorized_gather_kernel", 1600, 1700, True),
           _Ev("engine.step", 0, 2000, False),
           _Ev("aten::item", 400, 900, False)]
    prof = types.SimpleNamespace(events=lambda: evs)
    out = profiling.summarize(prof, 0.002)
    assert out["busy_s"] == pytest.approx((300 + 500 + 100) / 1e6)
    assert out["fum_s"] == pytest.approx(100 / 1e6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"gemm": 250e-6, "elementwise": 500e-6, "fum": 100e-6,
         "index": 100e-6})
    assert out["idle_gaps"][0][0] == "engine.step"
    assert out["idle_gaps"][0][1] == pytest.approx(700e-6)
    assert out["idle_gaps"][1][1] == pytest.approx(100e-6)
