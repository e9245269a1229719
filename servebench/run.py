"""The serving benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 -m servebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell is an entry of
``BENCHMARK.json``'s ``workloads``; its configuration file, its traffic
file (``servebench/traffic/<traffic>.json``), its correctness limits
(``servebench/limits/<cell>.json``) and one reader per metric
(``servebench/metrics/<metric>.py``) are found by the names there, so a
cell, a mix or a metric is added by adding files and entries.

One process: weights drawn from the seed on the card, the engine
(``repro_torch.serving.Engine``) built as the configuration file says,
its prefill shapes and decode graph warmed up, the closed loop ramped,
``--seconds`` measured, the counted requests drained, then the check of
the served tokens against the plain reference (``check.py``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1`` also
the profiler slice's ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit,
also printed as the last lines of standard error.

It fails, printing no result, without a CUDA card, when the checkout
lacks the program (``src/repro_torch``), and when JAX or the JAX package
is loaded once the window has closed. Kernel and compile caches stay in
``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the engine's host work is one Python
# thread, and idle pool threads only add jitter to its steps
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds of the profiler slice in a traced run
SLICE_S = 2.0
#: served tokens the check reads, besides the longest request
POOL_TOKENS = 400


def prepare_env(root: Path = ROOT) -> None:
    """Caches inside the checkout, the program on the path, and no
    ``REPRO_*`` override of what the configuration file states."""
    for key in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[key]
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by its
    names: configuration, traffic, limits and its metrics' entries."""

    def __init__(self, name: str, conf: Dict, traffic: Dict, limits: Dict,
                 end_to_end: List[Dict], per_layer: List[Dict], chips: int):
        self.name, self.conf, self.traffic = name, conf, traffic
        self.limits, self.chips = limits, chips
        self.end_to_end, self.per_layer = end_to_end, per_layer

    @staticmethod
    def load(name: str, root: Path = ROOT) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
        if work is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in bench["configs"] if c["name"] == work["config"])
        conf = json.loads((root / entry["file"]).read_text())
        traffic = json.loads(
            (HERE / "traffic" / f"{work['traffic']}.json").read_text())
        limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

        def mine(ms):
            return [m for m in ms if name in m.get("workloads", [name])]

        return Cell(name, conf, traffic, limits, mine(bench["end_to_end"]),
                    mine(bench["per_layer"]), work["chips"])


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"servebench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def port_config(conf: Dict):
    """The program's registered config, held equal to the file's shapes."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(conf["port_config"])
    diff = {k: (v, getattr(cfg, k)) for k, v in conf["model"].items()
            if getattr(cfg, k) != v}
    if dataclasses.asdict(cfg.hdp) != conf["hdp"]:
        diff["hdp"] = (conf["hdp"], dataclasses.asdict(cfg.hdp))
    if diff:
        raise ValueError(f"{conf['name']}: the file's shapes differ from the "
                         f"program's registered config: {diff}")
    return cfg


def build_engine(cfg, params, conf: Dict, device, collect_stats: bool):
    from repro_torch.attention import AttnSpec
    from repro_torch.serving import Engine
    from repro_torch.serving.scheduler import SchedulerConfig
    e = conf["engine"]
    return Engine(cfg, params, device=device, max_batch=e["max_batch"],
                  max_len=e["max_len"],
                  prefill_buckets=tuple(e["prefill_buckets"]),
                  collect_stats=collect_stats,
                  attn=AttnSpec(kv_dtype=e["kv_dtype"],
                                kv_scale=e["kv_scale"], policy="static"),
                  num_pages=e["num_pages"], prefix_cache=e["prefix_cache"],
                  decode_horizon=e["decode_horizon"], spec_decode=False,
                  adaptive_spec=False, stream_sched=e["stream_sched"],
                  sched=SchedulerConfig() if e["stream_sched"] else None)


def judge(cell: Cell, W, load, w, dev) -> Dict:
    """The cell's comparison with the reference (``check.py``): every
    number of the check, the requests and served tokens it covered."""
    from servebench import check
    prec = check.Prec(cell.conf["model"]["dtype"])
    seqs = check.pool_seqs(load, w.records)
    if seqs:
        got = check.numbers(W, cell.conf, seqs, prec, dev)
    else:
        got = dict(dict.fromkeys(cell.limits, float("inf")), tokens=0)
    return dict(got, seqs=seqs, requests=len(seqs))


def measure(cell: Cell, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", cfg=None, t_process: float = T_PROCESS,
            log=None, keep_weights: bool = False) -> Dict:
    """One run of ``cell``: the result's keys, and ``log`` lines for
    standard error. ``cfg`` replaces the program's registered config (the
    CPU tests' reduced shapes)."""
    import torch

    from servebench import profiling, weights
    from servebench.drive import Load, warm_up

    torch.set_num_threads(1)
    log = log if log is not None else []
    if cfg is None:
        cfg = port_config(cell.conf)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    card = card_limit() if cuda else "cpu"
    marks = [("imports", time.perf_counter())]
    with torch.inference_mode():
        W = weights.draw(cfg, seed, dev)
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append(("weights", time.perf_counter()))
        eng = build_engine(cfg, W, cell.conf, dev, collect_stats=trace)
        if eng.pages.page_size != cell.conf["hdp"]["block_k"]:
            raise ValueError("pool pages are not the HDP key blocks")
        marks.append(("engine", time.perf_counter()))
        warm_up(eng, cell.conf, cell.traffic, seed)
        # set-up's objects out of the collector's way: its passes in the
        # window then scan only what the window itself allocates
        gc.collect()
        gc.freeze()
        marks.append(("warm-up", time.perf_counter()))
        slice_s = min(SLICE_S, seconds / 3) if trace and cuda else None
        capture = {"layers": cfg.n_layers, "share": 0.3,
                   "tokens": POOL_TOKENS}
        load = Load(eng, cell.traffic, cell.conf, seed, seconds, slice_s,
                    capture)
        w = load.run(t_process)
        if cuda:
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    w.kind, w.card = kind, card
    marks.append(("ramp", w.t_start))
    t_prev, parts = t_process, []
    for name, t in marks:
        parts.append(f"{name} {t - t_prev:.2f}")
        t_prev = t
    log.append("setup s: " + ", ".join(parts))
    if load.prof is not None and load.prof_t[1] is not None:
        w.trace = profiling.summarize(load.prof, load.prof_t[1] - load.prof_t[0])
        w.trace["decode_steps"] = load.trace_steps[1] - load.trace_steps[0]
    counted = w.counted
    failed = sum(r.result is None or r.result.status != "ok" for r in counted)
    short = sum(r.result is not None and r.result.status == "ok"
                and len(r.result.tokens) != r.max_new for r in counted)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"])(w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ttfts = sorted(r.result.ttft_s for r in counted if r.result is not None
                   and r.result.ttft_s is not None)
    if ttfts:
        log.append("ttft s: p50 %.3f p90 %.3f p95 %.3f p99 %.3f of %d" % tuple(
            [float(np.percentile(ttfts, q)) for q in (50, 90, 95, 99)]
            + [len(ttfts)]))
    log.append(f"run: {len(counted)} requests sent in {w.seconds:.3f} s, "
               f"{len(w.admitted)} admitted, {load.unaccounted} of "
               f"{len(w.records)} not accounted for; {card}")
    # the program's state goes before the reference runs
    load.eng = eng = None
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    got = judge(cell, W, load, w, dev)
    log.append(f"check: {got['requests']} requests, {got['tokens']} "
               f"served tokens, reference {time.perf_counter() - t0:.1f} s")
    for key in ("logit_gap_max", "logit_gap_mean", "top1_miss_share"):
        if key in got and key not in cell.limits:
            log.append(f"not compared: {key} {got[key]!r}")
    checks = {n: {"value": got[n], "limit": lim}
              for n, lim in cell.limits.items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["short_answers"] = {"value": short, "limit": 0}
    correct = got["requests"] > 0 and all(c["value"] <= c["limit"]
                                          for c in checks.values())
    devinfo = {"platform": "gpu" if cuda else "cpu", "kind": kind,
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(counted), "failed": failed,
           "metrics": metrics, "device": devinfo}
    if trace and w.trace is not None:
        devinfo["busy_s"] = w.trace["busy_s"]
        devinfo["window_s"] = w.trace["window_s"]
        out["breakdown"] = {"device_ops": w.trace["device_ops"],
                            "idle_gaps": w.trace["idle_gaps"]}
    out["checks"] = checks
    if keep_weights:
        out["_weights"], out["_checked"] = W, got
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    cell = Cell.load(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"servebench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    log: List[str] = []
    out = measure(cell, args.seed, args.seconds, bool(args.trace), log=log)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: loaded in the run's process: {bad}",
              file=sys.stderr)
        return 4
    for line in log:
        print(line, file=sys.stderr)
    for name, m in out["metrics"].items():
        print(f"metric {name} {m['value']!r} {m['unit']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
