"""Multi-pod dry run: trace every (arch x shape) cell per shard on the
production meshes, record its memory and cost, dump roofline JSON.

PyTorch counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell on 512 forced host devices and reads the compiled
module's memory and HLO cost. The port has no compiler: it builds each
cell's step on a *traced* mesh (``launch.mesh.traced_mesh``: the 16x16
or 2x16x16 production mesh bound to rank 0's coordinates, with no
process groups) and runs it once under ``FakeTensorMode``, counting
every aten op and every collective that rank would run
(``roofline.trace_cost``). Nothing is allocated and nothing runs on a
GPU, so it works on any host:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a]
        [--shape s] [--mesh single|multi|both] [--out build/x.json]
        [--append]

``spec_for`` shards only the dims a mesh axis divides, so every rank's
shards have rank 0's shapes and rank 0 stands for all. Each record has
the reference's keys, with ``trace_s`` (the seconds the trace took) in
the place of ``compile_s``; ``fits_hbm`` compares the peak with the
H100's memory. Exit code 1 if any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.common import tree
from repro_torch.configs import (SHAPES, cell_applicable, get_config,
                                 list_configs)
from repro_torch.distribution import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, traced_mesh
from repro_torch.launch.steps import BuiltStep, build_step
from repro_torch.roofline import analysis, trace_cost

DEFAULT_OUT = os.path.join("build", "dryrun_results.json")


def _fake_args(built: BuiltStep, mesh):
    """The step's arguments as this rank holds them, made under the
    trace's FakeTensorMode: params, optimizer state and caches as their
    shards by ``built.in_specs``; the batch (or tokens) whole, as every
    rank of the port's mesh steps takes the global batch and selects its
    rows; the decode position a scalar."""
    def make(x, spec):
        shape = tuple(x.shape) if spec is None or mesh is None else \
            shd.local_shape(x.shape, spec, mesh)
        return torch.empty(shape, dtype=x.dtype)

    kind = built.meta["kind"]
    out = []
    for i, (arg, specs) in enumerate(zip(built.args, built.in_specs)):
        whole = (kind == "train" and i == 2) or (kind != "train" and i == 1)
        if whole or specs is None:
            out.append(tree.tree_map(lambda x: make(x, None), arg)
                       if isinstance(arg, dict) else make(arg, None))
        else:
            out.append(shd.map_specs(make, arg, specs))
    return tuple(out)


def trace_cell(cfg, shape, mesh, *, rank: int = 0, unroll: bool = False,
               **step_kwargs):
    """(BuiltStep, Traced) of ``cfg`` x ``shape`` for ``rank`` of ``mesh``
    (an abstract mesh, traced at that rank; None: one device):
    ``trace_cost.trace`` of the built step on its fake arguments."""
    on = None if mesh is None else traced_mesh(mesh, rank)
    built = build_step(cfg, shape, on, **step_kwargs)
    return built, trace_cost.trace(built.fn, lambda: _fake_args(built, on),
                                   unroll=unroll)


def record(cfg, shape, n_dev: int, built: BuiltStep,
           traced: trace_cost.Traced) -> dict:
    """The dry-run record fields of one traced cell."""
    roof = analysis.analyze(
        traced, model_flops_per_device=analysis.model_flops(cfg, shape,
                                                            n_dev))
    mem = traced.memory
    return {"n_devices": n_dev,
            "num_microbatches": built.meta.get("num_microbatches"),
            "memory": dict(mem), "roofline": roof.as_dict(),
            "fits_hbm": bool(mem["peak_bytes"] < analysis.HBM_BYTES)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             step_kwargs=None, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        built, traced = trace_cell(cfg, shape, mesh, **(step_kwargs or {}))
        rec.update(status="ok", trace_s=round(time.time() - t0, 1),
                   **record(cfg, shape, mesh.size, built, traced))
        if verbose:
            m, r = rec["memory"], rec["roofline"]
            print(f"[{rec['mesh']}] {arch} x {shape_name}: OK "
                  f"({rec['trace_s']}s) peak={m['peak_bytes']/1e9:.2f}GB "
                  f"fits={rec['fits_hbm']} flops={r['flops']:.3e} "
                  f"bottleneck={r['bottleneck']} "
                  f"(c={r['compute_t']*1e3:.2f}ms m={r['memory_t']*1e3:.2f}ms "
                  f"l={r['collective_t']*1e3:.2f}ms)", flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug, record it
        rec.update(status="fail", trace_s=round(time.time() - t0, 1),
                   error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape_name}: FAIL {e}",
                  flush=True)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(list_configs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    for multi in meshes:
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    continue
                rec = run_cell(arch, shape, multi_pod=multi)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"])
                           != (arch, shape, mesh_name)] + [rec]
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip (documented), {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
