"""Measure the card's hardware-profile constants beside the profile.

    python -m repro_torch.launch.measure_profile

prints one JSON line: the card's name, power limit and memory, a
device-to-device copy's bandwidth (1 GiB, read + write counted, median
of 10), a bf16 8192^3 ``torch.matmul`` rate (median of 10), and the two
dispatch constants of ``roofline.hardware.HardwareProfile``:

* ``dispatch_s`` — one replay of a CUDA graph holding one tiny kernel,
  synchronized, on the host's clock (median of 200): what a step that
  replays one graph pays before any work;
* ``op_overhead_s`` — a graph of ``N_NODES`` tiny kernels replayed, the
  device time per node (CUDA events, median of 20): what one more
  kernel launch inside a step costs.

The copy and the matmul are measuring tools, not ports of anything; they
hold the profile's ``hbm_bw`` and ``peak_flops`` to account (a reading
above the peak means the yardstick is wrong). ``chip_smoke.py`` phase 5h
runs ``measure`` and prints it beside ``detect_profile()``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

#: tiny kernels in the op-overhead graph
N_NODES = 1000


def _event_ms(torch, fn, reps: int) -> list:
    """Device milliseconds of ``fn`` per rep (CUDA events), after one
    untimed run."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def smi_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def measure(torch) -> dict:
    """The measurements above on ``cuda:0``, as a dict of floats."""
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    out = {"name": torch.cuda.get_device_name(dev),
           "total_memory": int(props.total_memory)}

    n = 2 ** 30
    src = torch.empty(n, dtype=torch.uint8, device=dev).fill_(1)
    dst = torch.empty_like(src)
    ms = statistics.median(_event_ms(torch, lambda: dst.copy_(src), 10))
    out["copy_bytes"] = 2 * n
    out["copy_bytes_s"] = 2 * n / (ms * 1e-3)
    del src, dst

    m = 8192
    a = torch.randn(m, m, device=dev, dtype=torch.bfloat16)
    b = torch.randn(m, m, device=dev, dtype=torch.bfloat16)
    ms = statistics.median(_event_ms(torch, lambda: torch.matmul(a, b), 10))
    out["matmul_bf16_flop_s"] = 2.0 * m ** 3 / (ms * 1e-3)
    del a, b

    x = torch.zeros(1, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x.add_(1.0)                     # warm-up: loads the kernel
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    one = torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        x.add_(1.0)
    many = torch.cuda.CUDAGraph()
    with torch.cuda.graph(many):
        for _ in range(N_NODES):
            x.add_(1.0)
    torch.cuda.synchronize()
    for _ in range(20):
        one.replay()
    torch.cuda.synchronize()
    host = []
    for _ in range(200):
        t0 = time.perf_counter()
        one.replay()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    out["dispatch_s"] = statistics.median(host)
    ms = statistics.median(_event_ms(torch, many.replay, 20))
    out["op_overhead_s"] = ms * 1e-3 / N_NODES
    out["op_graph_nodes"] = N_NODES
    del one, many
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("measure_profile needs a CUDA card", file=sys.stderr)
        return 2
    rec = measure(torch)
    rec["smi"] = smi_line()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
