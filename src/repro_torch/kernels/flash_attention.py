"""Dense flash attention: wrapper of the CUDA kernels.

``flash_attention`` is the port of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``, the paper's
HDP-off baseline. On a CUDA tensor the wrapper launches a kernel or
raises; on a CPU tensor it runs the plain version
``ref.flash_attention_plain``.

Two kernels serve CUDA tensors, picked by ``flash_path`` from the call's
dtype and head size alone: the tensor-core kernel
(``csrc/flash_attention_tc.cu``) for bf16 with hd 64, 112 or 128, the
CUDA-core tile kernel (``csrc/flash_attention.cu`` and
``csrc/attn_tile.cuh``) for fp32 and other head sizes.
``flash_attention.launches`` counts kernel launches,
``.launches_by_path`` them per path.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.hdp_block_attn import (PATHS, TC_HEAD_DIMS,
                                                check_tile_shapes)
from repro_torch.kernels.ref import flash_attention_plain

#: the CUDA source (and C prefix) of each path
SOURCES = {"tensor_core": "flash_attention_tc", "tile": "flash_attention"}

_libs: Dict[str, ctypes.CDLL] = {}   # loaded (and built) at first launch


def _library(path: str) -> ctypes.CDLL:
    if path not in _libs:
        name = SOURCES[path]
        lib = build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [p] * 4 + ([i] * 5 if path == "tensor_core"
                                 else [i] * 8) + [ctypes.c_float, p]
        fn.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        _libs[path] = lib
    return _libs[path]


def flash_path(dtype: torch.dtype, hd: int, block_q: int,
               block_k: int) -> str:
    """Which kernel serves a CUDA call, from types and shapes alone:
    "tensor_core" for bfloat16 with hd in ``TC_HEAD_DIMS`` (the kernel
    walks its own 128x128 tiles: the dense result does not depend on the
    tiling, whose blocks only move where the online softmax rounds);
    else "tile" within the tile kernel's limits (``check_tile_shapes``);
    a shape that neither takes raises ValueError."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS \
            and block_q >= 1 and block_k >= 1:
        return "tensor_core"
    check_tile_shapes(hd, block_q, block_k)
    return "tile"


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q,k,v [B,H,S,hd] of one dtype (float32 or bfloat16) ->
    [B,H,Sq,hd] in that dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q/k/v must be [B,H,S,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"all inputs must be on {q.device}")
    build.refuse_trace("flash_attention", q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, Sq, hd = q.shape
    path = flash_path(q.dtype, hd, block_q, block_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _library(path)
    name = SOURCES[path]
    vp = ctypes.c_void_p
    ptrs = (vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
            vp(out.data_ptr()))
    ints = (B * H, Sq, k.shape[2], hd, int(causal)) \
        if path == "tensor_core" else \
        (int(q.dtype == torch.bfloat16), B * H, Sq, k.shape[2], hd, block_q,
         block_k, int(causal))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *ptrs, *ints,
            ctypes.c_float(float(np.float32(1.0 / hd ** 0.5))), vp(stream))
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"flash_attention ({path}) launch failed for "
                           f"blocks {block_q}x{block_k}, hd={hd}: {msg}")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
