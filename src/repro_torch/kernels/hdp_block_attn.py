"""Block-sparse FUM attention: wrapper of the CUDA kernel.

``hdp_block_sparse_attention`` is the port of the TPU kernel
``repro/kernels/hdp_block_attn.py:hdp_block_sparse_attention``:
attention over only the KV blocks each (b·h, q tile) lists, with the
paper's QKᵀ − FQ·FKᵀ scores and the early head gate (see
``csrc/hdp_block_attn.cu`` and ``csrc/attn_tile.cuh``). On a CUDA tensor
the wrapper launches a kernel or raises; on a CPU tensor it runs the
plain version ``ref.hdp_block_sparse_attention_plain``.

Two kernels serve CUDA tensors, picked by ``block_path`` from the call's
types and shapes alone: the tensor-core kernel
(``csrc/hdp_block_attn_tc.cu``: the fixed-grid scores as exact bf16 limb
products, ``fixed_limbs``) for bf16 V, hd 64 or 128 and blocks of 64 or
128 rows and columns, the aligned prefill's shapes; the CUDA-core tile
kernel for the rest (fp32 V, as the paged decode's densified route
passes, and small blocks or head sizes). ``hdp_block_sparse_attention
.launches`` counts kernel launches, ``.launches_by_path`` them per path;
a call under CUDA graph capture counts once, where it records the
kernel, and the graph's replays do not call the wrapper.
``hdp_block_sparse_attention.runs`` is the tile kernel's own count on
the card (``build.RunCounter``), a graph's replays included.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (f32_scalar,
                                     hdp_block_sparse_attention_plain)

F32 = torch.float32

#: the two kernels behind the wrappers of this module and flash's
PATHS = ("tensor_core", "tile")
#: head sizes the tensor-core kernels take
TC_HEAD_DIMS = (64, 128)
#: block sizes (rows and columns) the tensor-core block kernel takes
TC_BLOCKS = (64, 128)

#: the CUDA source (and C prefix) of each path
SOURCES = {"tensor_core": "hdp_block_attn_tc", "tile": "hdp_block_attn"}

_libs: Dict[str, ctypes.CDLL] = {}   # loaded (and built) at first launch


def _library(path: str) -> ctypes.CDLL:
    if path not in _libs:
        name = SOURCES[path]
        lib = build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([p] * 9 if path == "tensor_core"
                       else [p] * 3 + [i] + [p] * 7) \
            + [i] * 9 + [ctypes.c_float, p]
        fn.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        _libs[path] = lib
    return _libs[path]


def fixed_limbs(x: torch.Tensor):
    """The tensor-core kernel's exact split of fixed-grid values (Q4.12)
    into three bf16 limbs: I = trunc(x), F_hi = bf16(x - I) and F_lo =
    x - I - F_hi. For grid values I + F_hi + F_lo == x exactly, every
    product of two limbs is exact in fp32, and the FUM score is
    QQ·KQᵀ − FQ·FKᵀ = IQ·IK + IQ·FK_hi + IQ·FK_lo + FQ_hi·IK + FQ_lo·IK."""
    x = x.to(F32)
    i = torch.trunc(x)
    f = x - i
    hi = f.to(torch.bfloat16)
    lo = (f - hi.to(F32)).to(torch.bfloat16)
    return i.to(torch.bfloat16), hi, lo


def block_path(v_dtype: torch.dtype, hd: int, block_q: int,
               block_k: int) -> str:
    """Which kernel serves a CUDA call, from types and shapes alone:
    "tensor_core" for bf16 V, hd in ``TC_HEAD_DIMS`` and block_q,
    block_k in ``TC_BLOCKS``; else "tile" within the tile kernel's limits
    (``check_tile_shapes``); a shape that neither takes raises
    ValueError."""
    if v_dtype == torch.bfloat16 and hd in TC_HEAD_DIMS \
            and block_q in TC_BLOCKS and block_k in TC_BLOCKS:
        return "tensor_core"
    check_tile_shapes(hd, block_q, block_k)
    return "tile"


def check_tile_shapes(hd: int, block_q: int, block_k: int) -> None:
    """The tile kernels' limits: hd a multiple of 4 up to 128 (shared
    memory), blocks of 1 to 128 rows and columns."""
    if hd % 4 or not 4 <= hd <= 128:
        raise ValueError(f"the kernel needs hd a multiple of 4 up to 128, "
                         f"got {hd}")
    if not (1 <= block_q <= 128 and 1 <= block_k <= 128):
        raise ValueError(f"the kernel takes blocks up to 128x128, got "
                         f"{block_q}x{block_k}")


def hdp_block_sparse_attention(q, k, v, kv_idx, counts, head_kept, *,
                               causal: bool = True, approx: bool = True,
                               block_q: int = 128, block_k: int = 128,
                               score_scale=None, kv_len=None):
    """q,k [B,H,S,hd] fp32 fixed-grid; v [B,H,Sk,hd] fp32 or bf16;
    kv_idx [B,H,nq,max_keep] int; counts [B,H,nq]; head_kept [B,H]
    (bool/int); score_scale: optional calibration rescale 1/(s_q·s_k)
    (a number or a one-element tensor); kv_len [B,H] optional valid KV
    extent per row (defaults to Sk). Returns [B,H,Sq,hd] fp32. KV blocks
    absent from ``kv_idx[..., :counts]`` are never read."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q/k/v must be [B,H,S,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q/k must be float32 and v float32 or bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    nq = -(-Sq // block_q)
    if kv_idx.dim() != 4 or tuple(kv_idx.shape[:3]) != (B, H, nq) \
            or tuple(counts.shape) != (B, H, nq) \
            or tuple(head_kept.shape) != (B, H) \
            or (kv_len is not None and tuple(kv_len.shape) != (B, H)):
        raise ValueError(
            f"kv_idx [B,H,nq,mk], counts [B,H,nq], head_kept [B,H] and "
            f"kv_len [B,H] expected for B,H,nq = {(B, H, nq)}, got "
            f"{tuple(kv_idx.shape)}, {tuple(counts.shape)}, "
            f"{tuple(head_kept.shape)}, "
            f"{None if kv_len is None else tuple(kv_len.shape)}")
    for t in (k, v, kv_idx, counts, head_kept) + \
            (() if kv_len is None else (kv_len,)):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
    if q.device.type == "cpu":
        return hdp_block_sparse_attention_plain(
            q, k, v, kv_idx, counts, head_kept, causal=causal,
            approx=approx, block_q=block_q, block_k=block_k,
            score_scale=score_scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    path = block_path(v.dtype, hd, block_q, block_k)
    i32 = torch.int32
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    idx = kv_idx.to(i32).contiguous()
    cnt = counts.to(i32).contiguous()
    hk = head_kept.to(i32).contiguous()
    lens = None if kv_len is None else kv_len.to(i32).contiguous()
    ss = None
    if score_scale is not None:
        ss = f32_scalar(score_scale, q.device).reshape(1).contiguous()
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    lib = _library(path)
    vp = ctypes.c_void_p
    ptrs = [vp(q.data_ptr()), vp(k.data_ptr()), vp(v.data_ptr())]
    if path == "tile":
        ptrs.append(int(v.dtype == torch.bfloat16))
    ptrs += [vp(out.data_ptr()), vp(idx.data_ptr()), vp(cnt.data_ptr()),
             vp(hk.data_ptr()), vp(0 if lens is None else lens.data_ptr()),
             vp(0 if ss is None else ss.data_ptr())]
    if path == "tile":
        ptrs.append(vp(hdp_block_sparse_attention.runs.tensor(q.device)
                       .data_ptr()))
    name = SOURCES[path]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *ptrs, B * H, Sq, Sk, hd, block_q, block_k, idx.shape[-1],
            int(causal), int(approx),
            ctypes.c_float(float(np.float32(1.0 / hd ** 0.5))), vp(stream))
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"hdp_block_sparse_attention ({path}) launch "
                           f"failed for blocks {block_q}x{block_k}, "
                           f"hd={hd}: {msg}")
    hdp_block_sparse_attention.launches += 1
    hdp_block_sparse_attention.launches_by_path[path] += 1
    return out


hdp_block_sparse_attention.launches = 0
hdp_block_sparse_attention.launches_by_path = dict.fromkeys(PATHS, 0)
hdp_block_sparse_attention.runs = build.RunCounter()
