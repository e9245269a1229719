"""Fault-tolerant checkpointing: atomic, self-describing, placed anywhere.

PyTorch counterpart of ``repro.training.checkpoint``, with the same
on-disk format (``repro-ckpt-v1``), so either package restores the
other's checkpoints::

    <dir>/step_00000120/
        manifest.json          # tree structure, shapes/dtypes, step, meta
        shard_00000.npz        # leaf_00000... in JAX's flatten order
    <dir>/LATEST               # atomically-updated pointer file

Guarantees:

* **Atomic**: writes go to ``step_X.tmp_<nonce>`` and are renamed into
  place only after everything (including the manifest) is fsync'd; a crash
  mid-save never corrupts the previous checkpoint, and ``LATEST`` is
  updated last via rename (POSIX-atomic).
* **Elastic**: leaves are stored as full logical arrays, so a checkpoint
  restores onto whatever device the caller runs (``load_checkpoint``'s
  ``device``). Device placement is not part of the format.
* **Self-describing**: the manifest records the flattened tree structure
  (the reference's ``PyTreeDef`` string and key paths) + per-leaf
  shape/dtype, validated on load.
* **Retention**: ``keep`` most recent checkpoints are retained; older ones
  are deleted only after a newer save fully commits.

**bf16 leaves** are stored as the reference's file holds them: numpy has
no bfloat16 of its own, so the array is the 2-byte void dtype ``|V2``
holding the bf16 bits, with ``"bfloat16"`` in the manifest. On load the
bytes are viewed as ``torch.bfloat16`` by the manifest's dtype, exactly.
(The reference's own loader cannot cast a ``|V2`` array back to bf16 and
raises: ROADMAP.md section 3.)
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import tree

_MANIFEST = "manifest.json"
_LATEST = "LATEST"
_BF16 = "bfloat16"


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A leaf as the numpy array the file holds (bf16: its bits as |V2)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(x)


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = np.array(a, order="C")      # a C-ordered copy that keeps 0-d
    if dtype_name == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def save_checkpoint(directory: str, step: int, state: Dict[str, Any], *,
                    keep: int = 3, meta: Optional[Dict] = None) -> str:
    """Atomically persist ``state`` (a tree of tensors + scalars).

    Returns the committed checkpoint path.
    """
    os.makedirs(directory, exist_ok=True)
    leaves, paths = tree.flatten_with_paths(state)
    host_leaves = [_to_host(x) for x in leaves]

    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp_", dir=directory)
    try:
        arrays = {_leaf_key(i): a for i, a in enumerate(host_leaves)}
        shard_path = os.path.join(tmp, "shard_00000.npz")
        np.savez(shard_path, **arrays)

        manifest = {
            "format": "repro-ckpt-v1",
            "step": int(step),
            "time": time.time(),
            "process_count": _process_count(),
            "n_leaves": len(host_leaves),
            "treedef": tree.treedef_str(state),
            "paths": paths,
            "leaves": [{"shape": list(a.shape), "dtype": _dtype_name(x)}
                       for x, a in zip(leaves, host_leaves)],
            "meta": meta or {},
        }
        mpath = os.path.join(tmp, _MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

        if os.path.exists(final):          # overwrite-same-step: replace
            shutil.rmtree(final)
        os.rename(tmp, final)              # commit point
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    # LATEST pointer: write-then-rename (atomic on POSIX).
    lp = os.path.join(directory, _LATEST)
    with tempfile.NamedTemporaryFile("w", dir=directory, delete=False) as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
        tmp_latest = f.name
    os.rename(tmp_latest, lp)

    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp_" not in d)
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # Garbage-collect orphaned tmp dirs from crashed saves.
    for d in os.listdir(directory):
        if ".tmp_" in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    lp = os.path.join(directory, _LATEST)
    if not os.path.exists(lp):
        return None
    with open(lp) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        # LATEST points at a deleted/corrupt dir; fall back to newest valid.
        cands = sorted(
            d for d in os.listdir(directory)
            if d.startswith("step_") and ".tmp_" not in d
            and os.path.exists(os.path.join(directory, d, _MANIFEST)))
        if not cands:
            return None
        name = cands[-1]
    return int(name.split("_")[1])


def _target_device(tgt, device):
    if device is not None:
        return torch.device(device)
    if isinstance(tgt, torch.Tensor) and tgt.device.type != "meta":
        return tgt.device
    raise ValueError("load_checkpoint: a target leaf has no device of its "
                     "own (a shape/dtype stand-in or a meta tensor); pass "
                     "device=")


def load_checkpoint(directory: str, like: Dict[str, Any], *,
                    step: Optional[int] = None, device=None,
                    ) -> Tuple[Dict[str, Any], int, Dict]:
    """Restore a checkpoint into the structure of ``like``.

    ``like`` supplies the target tree (leaves with ``.shape`` and
    ``.dtype``: tensors, meta tensors or ``registry.ShapeDtype``s); a
    stored leaf whose dtype differs from its target's is cast to it.
    ``device``: where every leaf is placed (the elastic path: leaves are
    full logical arrays, placed wherever the caller runs now); None
    places each leaf on its ``like`` leaf's device. Returns (state, step,
    meta).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    like_leaves = tree.leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target tree has "
            f"{len(like_leaves)} — structure mismatch (paths in manifest: "
            f"{manifest['paths'][:5]}...)")

    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        raw = [z[_leaf_key(i)] for i in range(manifest["n_leaves"])]

    for i, (a, tgt) in enumerate(zip(raw, like_leaves)):
        want = list(getattr(tgt, "shape", a.shape))
        if list(a.shape) != want:
            raise ValueError(
                f"leaf {manifest['paths'][i]}: checkpoint shape {a.shape} "
                f"!= target {tuple(want)} (elastic restore changes "
                "placement, not logical shapes)")

    out = []
    for a, spec, tgt in zip(raw, manifest["leaves"], like_leaves):
        t = _from_host(a, spec["dtype"])
        dt = getattr(tgt, "dtype", t.dtype)
        out.append(t.to(device=_target_device(tgt, device), dtype=dt))
    state = tree.unflatten(like, out)
    return state, step, manifest.get("meta", {})


class CheckpointManager:
    """Policy wrapper: save every N steps + on demand, resume, retention."""

    def __init__(self, directory: str, *, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self._last_saved = -1

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0 \
            and step != self._last_saved

    def save(self, step: int, state, meta=None, *,
             write: bool = True) -> Optional[str]:
        """Save ``state`` at ``step``; ``write=False`` records the step as
        saved without writing (the ranks of a sharded run other than the
        one that writes the gathered state)."""
        p = save_checkpoint(self.directory, step, state, keep=self.keep,
                            meta=meta) if write else None
        self._last_saved = step
        return p

    def maybe_save(self, step: int, state, meta=None) -> Optional[str]:
        if self.should_save(step):
            return self.save(step, state, meta)
        return None

    def restore_or(self, like, init_fn: Callable[[], Any], *,
                   device=None) -> Tuple[Any, int, Dict]:
        """Resume from latest if present, else ``init_fn()`` at step 0."""
        if latest_step(self.directory) is None:
            return init_fn(), 0, {}
        return load_checkpoint(self.directory, like, device=device)
