"""Dense flash attention: wrapper of the CUDA kernel.

``flash_attention`` is the port of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``, the paper's
HDP-off baseline (see ``csrc/flash_attention.cu`` and
``csrc/attn_tile.cuh``). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
``ref.flash_attention_plain``. ``flash_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.hdp_block_attn import check_tile_shapes
from repro_torch.kernels.ref import flash_attention_plain

_lib: Optional[ctypes.CDLL] = None   # loaded (and built) at first launch


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = \
            [p] * 4 + [i] * 8 + [ctypes.c_float, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, Sq, hd = q.shape
    check_tile_shapes(hd, block_q, block_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _library()
    vp = ctypes.c_void_p
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr()),
            vp(out.data_ptr()), int(q.dtype == torch.bfloat16), B * H, Sq,
            k.shape[2], hd, block_q, block_k, int(causal),
            ctypes.c_float(float(np.float32(1.0 / hd ** 0.5))), vp(stream))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed for blocks "
                           f"{block_q}x{block_k}, hd={hd}: {msg}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
