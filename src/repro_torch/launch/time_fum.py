"""Median device time of the FUM decode kernel (int8 pool, pages split
across blocks) at ``chip_smoke.py``'s timing case: qwen2-1.5b's decode
shape B 8, N 2, G 6, hd 128, 128-position pages, 16 page slots a row,
seed 7 (5-11 pages listed a row).

    python src/repro_torch/launch/time_fum.py [--tree DIR] [--runs 300]

imports the port from ``DIR/src`` (default: this checkout), so it can
time the kernel of another checkout of the repository too: to compare
two versions, run it on one card from both, in turns (parent, change,
change, parent). Each run is enqueued behind a ~1 ms device spin with L2
flushed before it, as in ``chip_smoke.py``; prints one JSON line with
the median and quartiles and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--runs", type=int, default=300)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree) / "src"))
    import torch

    from repro_torch.core.quant import pool_scale, quantize_fixed
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.models.attention import _fetch_list

    if not torch.cuda.is_available():
        print("time_fum needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator().manual_seed(7)
    B, N, G, Sq, hd, ps, nP = 8, 2, 6, 1, 128, 128, 16
    P, Sk = 1 + B * nP, nP * ps
    qq = quantize_fixed(2.0 * torch.randn(B, N, G, Sq, hd, generator=g))
    kp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                       dtype=torch.int8)
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, nP)
    page_live = torch.rand(B, nP, generator=g) < 0.5
    keep = (torch.rand(B, N, G, nP, generator=g) < 0.6) \
        & page_live[:, None, None, :]
    fetched = keep.any(dim=2).any(dim=1)
    q0 = torch.randint(Sk // 2, Sk - Sq + 1, (B,), generator=g)
    q_pos = (q0[:, None] + torch.arange(Sq))[:, None, None, :]
    lists = _fetch_list(fetched, table, keep, q_pos)
    dev = [t.cuda() for t in (qq, kp, vp, *lists)]
    scales = {k: torch.full((P, N), pool_scale(4), device="cuda")
              for k in ("k_scale", "v_scale")}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    with torch.inference_mode():
        hdp_paged_fum_decode(*dev, **scales)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.runs):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            hdp_paged_fum_decode(*dev, **scales)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    times.sort()
    n = len(times)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": args.tree, "card": card,
                      "pages_listed": lists[2].tolist(),
                      "median_ms": times[n // 2], "q1_ms": times[n // 4],
                      "q3_ms": times[3 * n // 4]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
