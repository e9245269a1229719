"""Each script of ``examples_torch/`` runs on the CPU at reduced size.

Every script runs as a subprocess with ``--device cpu`` (the sweep and
the serve train ``bench-tiny`` for 3 steps into a ``CACHE_DIR`` under
``tmp_path``; the serve takes 3 requests x 2 new tokens; ``train_lm``
takes 2 steps into a checkpoint directory under ``tmp_path``), exits 0
and ends with its JAX twin's last line (the serve's with its TPU wording
replaced by the KV bytes a decode step reads). Each run also asserts
that ``jax``, ``repro``, ``benchmarks`` and ``examples`` stayed out of
``sys.modules`` (``test_torch_examples_isolation.py`` holds the
files' imports and the runs without a card).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the reference's timing tests share the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")
ENV = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
       "OMP_NUM_THREADS": "1"}

#: the script, its arguments after --device cpu, and the start of the
#: last line of its output
RUNS = {
    "quickstart": ([], "quickstart OK"),
    "pruning_sweep": (["--train-steps", "3"],
                      "pick the sparsest point that meets your fidelity "
                      "budget."),
    "serve_hdp": (["--train-steps", "3", "--requests", "3", "--max-new",
                   "2"],
                  "  FUM KV-read saving at this sparsity (32k ctx, per "
                  "seq/step): "),
    "train_lm": (["--steps", "2"], None),
}

#: runs the script as __main__ with CACHE_DIR set, then lists what of the
#: reference was imported
WRAPPER = """
import runpy, sys
from examples_torch import common
common.CACHE_DIR = sys.argv[1]
script = sys.argv[2]
sys.argv = sys.argv[2:]
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("IMPORTED", bad, file=sys.stderr)
"""


@pytest.mark.parametrize("name", sorted(RUNS))
def test_script_runs_on_cpu(name, tmp_path):
    args, last = RUNS[name]
    if name == "train_lm":
        args = args + ["--checkpoint-dir", str(tmp_path / "ckpt")]
    script = str(ROOT / "examples_torch" / f"{name}.py")
    proc = subprocess.run(
        [sys.executable, "-c", WRAPPER.format(forbidden=set(FORBIDDEN)),
         str(tmp_path / "cache"), script, "--device", "cpu", *args],
        env=ENV, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    err = proc.stderr.strip().splitlines()
    assert err[-1] == "IMPORTED []", err[-1]
    if name == "train_lm":
        # the launcher's log: the reference's "done: {...}" line
        assert " done: {'steps': 2," in err[-2], err[-2]
        assert (tmp_path / "ckpt").is_dir()
        return
    out = proc.stdout.rstrip("\n").splitlines()
    assert out[-1].startswith(last), out[-1]
    if name == "serve_hdp":
        assert out[-1].endswith("fewer KV bytes read per decode step)")
    if name in ("pruning_sweep", "serve_hdp"):
        assert os.listdir(tmp_path / "cache") == ["torch_tiny_s3.npz"]
