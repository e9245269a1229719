"""Readings for a cell's correctness limits, on the card at the cell's
own size: for each seed, one run of the cell with a short window (every
number of the check, on the run's sample), and the control on the same
sample (the reference one precision below the configuration's in the
program's place). One process for every seed, so the set-up's imports
and builds are paid once.

    python3 -m servebench.calibrate --workload olmoe-docqa --seconds 10 --seeds 1 2 3

prints one JSON line per seed; the limits in ``limits/<cell>.json`` are
set from these readings (``PERF.md`` lists them). ``--control-seeds``
limits the control to the first few seeds.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

#: the numbers of the check kept out of a row
_KEEP_OUT = ("logits", "seqs", "requests", "tokens")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    args = ap.parse_args(argv)
    from servebench import run
    run.prepare_env()
    import torch

    from servebench import check
    cell = run.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    n_ctl = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(args.seeds):
        log: List[str] = []
        t0 = time.perf_counter()
        out = run.measure(cell, seed, args.seconds, False, log=log,
                          keep_weights=True, t_process=t0)
        W, got = out.pop("_weights"), out.pop("_checked")
        row = {"workload": cell.name, "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"], "served_tokens": got["tokens"],
               "program": {k: v for k, v in got.items()
                           if k not in _KEEP_OUT},
               "failed": out["failed"], "log": log}
        if got["tokens"] and i < n_ctl:
            t1 = time.perf_counter()
            ctl = check.control_numbers(W, cell.conf, got["seqs"], got,
                                        "cuda")
            row["control"] = {k: v for k, v in ctl.items()
                              if k not in _KEEP_OUT}
            row["control_s"] = time.perf_counter() - t1
        print(json.dumps(row), flush=True)
        del W, got, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
