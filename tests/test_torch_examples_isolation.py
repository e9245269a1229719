"""``examples_torch/`` stands alone and never falls back to the CPU.

No file of ``examples_torch/`` imports ``jax``, ``repro``,
``benchmarks`` or ``examples`` (``test_torch_examples_scripts.py`` also
asserts, after each script's run, that none of them was loaded). Run
without ``--device cpu`` on a host without a card, each script fails
with the port's "CUDA is not available" error.
"""
from __future__ import annotations

import ast
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
FILES = sorted((ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")
SCRIPTS = ("pruning_sweep", "quickstart", "serve_hdp", "train_lm")
ENV = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
       "OMP_NUM_THREADS": "1"}


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


def test_the_five_files():
    assert [p.name for p in FILES] == [
        "common.py", "pruning_sweep.py", "quickstart.py", "serve_hdp.py",
        "train_lm.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", SCRIPTS)
def test_script_without_a_card_fails(name, tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py")],
        env=ENV, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr
