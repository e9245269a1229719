"""Bridge from the JAX package's parameter tree to the port's.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
returns the port's parameter dict. The layouts are identical, stacked
layers included, so the conversion is a copy; shapes are checked against
a freshly laid-out port tree so a mismatched config fails loudly, and
each leaf takes that tree's dtype: the model dtype for most, fp32 for
the leaves a model keeps in fp32 whatever its dtype (mamba2's
``A_log``). ``opt_state_from_jax`` moves the optimizer's state the same
way (m, v and master in fp32, the step a 0-d int32 tensor).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import registry


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype)


def _expected_shapes(cfg) -> Dict:
    """The port's parameter tree on the meta device (shapes only)."""
    return registry.init_params(cfg, device="meta")


def params_from_jax(cfg, tree, device, dtype: Optional[torch.dtype] = None):
    """JAX parameter tree (numpy leaves) -> port parameter dict on
    ``device``, each leaf in the dtype the port lays it out in for a
    model in ``dtype`` (default: the config's dtype)."""
    if dtype is not None:
        cfg = cfg.replace(dtype=L.torch_dtype(dtype))
    want = _expected_shapes(cfg)

    def conv(node, ref, path):
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(ref)}")
            return {k: conv(node[k], ref[k], f"{path}/{k}") for k in ref}
        t = _to_tensor(node, device, ref.dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        return t

    return conv(tree, want, "")


def opt_state_from_jax(cfg, opt_state, device) -> Dict:
    """JAX optimizer state ({"step", "m", "v", "master"}, numpy leaves) ->
    the port's (``training.optimizer.init_opt_state``'s tree) on
    ``device``: m, v and master through ``params_from_jax``'s tree check
    in fp32, the step a 0-d int32 tensor."""
    out = {k: params_from_jax(cfg, opt_state[k], device, torch.float32)
           for k in ("m", "v", "master")}
    step = np.asarray(opt_state["step"])
    if step.shape != () or not np.issubdtype(step.dtype, np.integer):
        raise ValueError(f"step: expected a 0-d integer array, got "
                         f"{step.dtype}{list(step.shape)}")
    out["step"] = torch.tensor(int(step), dtype=torch.int32, device=device)
    return {k: out[k] for k in ("step", "m", "v", "master")}
