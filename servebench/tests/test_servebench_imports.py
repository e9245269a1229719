"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (names compared whole),
and the reference loads nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
         "for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _loaded(
        "from servebench import run, check, calibrate, drive, profiling, "
        "peaks, weights, traffic\nrun.prepare_env()\n"
        "from repro_torch.serving import Engine\n"
        "from repro_torch.attention import AttnSpec\n"
        "from repro_torch.models import registry")
    assert not mods & BANNED
    assert "repro_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import servebench.reference.model, "
                   "servebench.reference.replay")
    assert not mods & (BANNED | {"repro_torch"})


def test_reference_sources_import_only_torch_numpy_and_itself():
    allowed = {"torch", "numpy", "dataclasses", "math", "typing",
               "__future__", "servebench"}
    for path in (ROOT / "servebench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
                if n.startswith("servebench"):
                    assert n.startswith("servebench.reference"), n


def test_nothing_under_servebench_imports_the_old_benchmarks():
    for path in (ROOT / "servebench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != "benchmarks"
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "benchmarks"
                           for a in node.names)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "servebench.run", "--workload", "olmoe-docqa",
         "--seed", str(2 ** 32 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "servebench", tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "servebench.run", "--workload", "granite-chat",
         "--seed", "7", "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
