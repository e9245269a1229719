"""Median device time of the FUM decode kernel (int8 pool) at one of
``chip_smoke.py``'s timing cases:

* ``--shape qwen2`` (default): qwen2-1.5b's decode shape B 8, N 2, G 6,
  hd 128, 128-position pages, 16 page slots a row, codes uniform over
  +-127, seed 7 (5-11 pages listed a row);
* ``--shape olmoe``: olmoe-1b-7b's (MHA) B 8, N 16, G 1, hd 128,
  128-position pages, 16 page slots a row, the unit-RMS queries and
  pool values of its qk-norm, seed 31 (4-9 pages listed a row), as
  ``chip_smoke.py``'s ``OLMOE_FUM_LABEL`` case.

``--sq`` gives the case that many query rows (the multi-query verify
shape; the same keep for every row). ``--splits S [S ...]`` times the
kernel at each S given (1: one pass; default: ``fum_splits``' choice),
interleaved run by run, so the values share the card's state.

    python src/repro_torch/launch/time_fum.py [--tree DIR] [--runs 300] \
        [--sq 1] [--shape qwen2|olmoe] [--splits S ...]

imports the port from ``DIR/src`` (default: this checkout), so it can
time the kernel of another checkout of the repository too: to compare
two versions, run it on one card from both, in turns (parent, change,
change, parent). Each run is enqueued behind a ~1 ms device spin with L2
flushed before it, as in ``chip_smoke.py``; prints one JSON line per S
with the median and quartiles and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


#: the two timing cases: (B, N, G, seed, unit-RMS values)
SHAPES = {"qwen2": (8, 2, 6, 7, False), "olmoe": (8, 16, 1, 31, True)}


def make_case(torch, shape, Sq):
    """The case's kernel inputs on the CPU, drawn in ``chip_smoke.py``'s
    ``make_case`` order from its seed: (args, k_scale/v_scale)."""
    from repro_torch.core.quant import encode_pool, pool_scale, quantize_fixed
    from repro_torch.models.attention import _fetch_list
    B, N, G, seed, unit = SHAPES[shape]
    hd, ps, nP = 128, 128, 16
    g = torch.Generator().manual_seed(seed)
    P, Sk = 1 + B * nP, nP * ps
    qq = quantize_fixed((1.0 if unit else 2.0)
                        * torch.randn(B, N, G, Sq, hd, generator=g))
    if unit:
        kp, vp = (encode_pool(torch.randn(P, ps, N, hd, generator=g))
                  for _ in range(2))
    else:
        kp, vp = (torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                                dtype=torch.int8) for _ in range(2))
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, nP)
    page_live = torch.rand(B, nP, generator=g) < 0.5
    keep = (torch.rand(B, N, G, nP, generator=g) < 0.6) \
        & page_live[:, None, None, :]
    fetched = keep.any(dim=2).any(dim=1)
    q0 = torch.randint(Sk // 2, Sk - Sq + 1, (B,), generator=g)
    q_pos = (q0[:, None] + torch.arange(Sq))[:, None, None, :]
    lists = _fetch_list(fetched, table, keep, q_pos)
    scales = {k: torch.full((P, N), pool_scale(4))
              for k in ("k_scale", "v_scale")}
    return (qq, kp, vp, *lists), scales


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--sq", type=int, default=1)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="qwen2")
    ap.add_argument("--splits", type=int, nargs="+", default=[None])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree) / "src"))
    import torch

    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode

    if not torch.cuda.is_available():
        print("time_fum needs a CUDA card", file=sys.stderr)
        return 2
    Sq = args.sq
    host, scales = make_case(torch, args.shape, Sq)
    dev = [t.cuda() for t in host]
    scales = {k: v.cuda() for k, v in scales.items()}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    times = {S: [] for S in args.splits}
    with torch.inference_mode():
        for S in args.splits:
            hdp_paged_fum_decode(*dev, **scales, splits=S)
        torch.cuda.synchronize()
        for _ in range(args.runs):
            for S in args.splits:
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                hdp_paged_fum_decode(*dev, **scales, splits=S)
                b.record()
                torch.cuda.synchronize()
                times[S].append(a.elapsed_time(b))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for S, ts in times.items():
        ts.sort()
        n = len(ts)
        print(json.dumps({"tree": args.tree, "card": card,
                          "shape": args.shape, "sq": Sq, "splits": S,
                          "pages_listed": host[5].tolist(),
                          "median_ms": ts[n // 2], "q1_ms": ts[n // 4],
                          "q3_ms": ts[3 * n // 4]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
