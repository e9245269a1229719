"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so nvcc compiles it in seconds into ``build/repro_torch/lib<name>-<hash>.so``
at the repository root (the hash covers the source, the ``csrc/``
headers it includes and the flags, so an edited source never loads a
stale library). The build happens at first
use, never at import; ``build_all`` starts one nvcc per source at once.
A failed build raises with nvcc's output. ``RunCounter`` is the count
on the card that a kernel keeps of its own runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built here")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_includes(path: Path, seen: set) -> None:
    """Add every ``csrc/`` header that ``path`` includes, transitively."""
    for inc in _INCLUDE.findall(path.read_bytes()):
        header = CSRC / inc.decode()
        if header.is_file() and header not in seen:
            seen.add(header)
            _local_includes(header, seen)


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    h = hashlib.sha1(source.read_bytes())
    headers = set()
    _local_includes(source, headers)
    for header in sorted(headers):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, nvcc: str):
    """Launch nvcc for one source; returns (process, tmp path, out path,
    start time), or None when the library is already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def build_all(names: Iterable[str]) -> Dict[str, Dict]:
    """Build every named source, one nvcc each, all started together.
    Returns name -> {"path", "seconds" (0 when already built), "log"
    (nvcc's output, ptxas register and spill report included)}; raises
    RuntimeError on any failure."""
    nvcc = find_nvcc()
    jobs = {n: _start(n, nvcc) for n in names}
    built, errors = {}, []
    for name, job in jobs.items():
        if job is None:
            built[name] = {"path": library_path(name), "seconds": 0.0,
                           "log": "already built"}
            continue
        proc, tmp, out, t0 = job
        log, _ = proc.communicate()
        if proc.returncode != 0 or not tmp.is_file():
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        built[name] = {"path": out, "seconds": time.perf_counter() - t0,
                       "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it if needed
    (callers keep the handle)."""
    return ctypes.CDLL(str(build_all([name])[name]["path"]))


class RunCounter:
    """A kernel's count of its own runs on the card: one thread of the
    kernel's first block adds one to an int64 there each time it runs,
    so a CUDA graph's replays count as well as direct launches (a
    wrapper's ``launches`` sees only the calls that record or launch).
    One counter per device, made at the first launch there and never
    moved, since a captured graph holds its address; that first launch
    must be eager (a capture would record the zero fill, not run it)."""

    def __init__(self):
        self._on: Dict[int, torch.Tensor] = {}

    def tensor(self, device) -> torch.Tensor:
        idx = torch.device(device).index
        idx = torch.cuda.current_device() if idx is None else idx
        t = self._on.get(idx)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel's first launch on a device "
                                   "must not be under CUDA graph capture: "
                                   "its run counter is made then")
            t = self._on[idx] = torch.zeros(1, dtype=torch.int64,
                                            device=f"cuda:{idx}")
        return t

    def read(self) -> int:
        """The runs counted on every device (waits for the card)."""
        return sum(int(t.item()) for t in self._on.values())

    def zero(self) -> None:
        for t in self._on.values():
            t.zero_()
