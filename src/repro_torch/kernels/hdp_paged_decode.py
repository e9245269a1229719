"""Gather-free paged FUM decode: wrapper of the CUDA kernel.

``hdp_paged_fum_decode`` is the port of the TPU kernel
``repro/kernels/hdp_paged_decode.py:hdp_paged_fum_decode``: stages 2 and
3 of every HDP decode layer, streaming only the pool pages that survived
the scout (see ``csrc/hdp_paged_decode.cu`` for the kernel and its
design). On a CUDA tensor the wrapper launches the kernel or raises; on
a CPU tensor it runs the plain version ``ref.hdp_paged_fum_decode_ref``.
``hdp_paged_fum_decode.launches`` counts kernel launches (the plain
version does not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref

_lib: Optional[ctypes.CDLL] = None   # loaded (and built) at first launch


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("hdp_paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hdp_paged_fum_decode_launch.argtypes = \
            [p] * 11 + [i] * 12 + [ctypes.c_float, p]
        lib.hdp_paged_fum_decode_launch.restype = i
        lib.hdp_paged_fum_decode_error_string.argtypes = [i]
        lib.hdp_paged_fum_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(qq, k_pool, v_pool, page_ids, logical, counts, keep, kv_len,
           k_scale, v_scale):
    if qq.dim() != 5 or qq.dtype != torch.float32:
        raise ValueError(f"qq must be float32 [B,N,G,Sq,hd], got "
                         f"{qq.dtype} {tuple(qq.shape)}")
    B, N, G, Sq, hd = qq.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool/v_pool must be [P,ps,N,hd] of one shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    P, ps, Np, hdp = k_pool.shape
    if (Np, hdp) != (N, hd):
        raise ValueError(f"pool heads/width {(Np, hdp)} != qq's {(N, hd)}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    pool_dt = torch.int8 if quantized else torch.float32
    if k_pool.dtype != pool_dt or v_pool.dtype != pool_dt:
        raise ValueError(
            f"{'int8 pools with scales' if quantized else 'float32 pools'} "
            f"expected, got {k_pool.dtype}/{v_pool.dtype}")
    mk = page_ids.shape[-1]
    want = {"page_ids": (page_ids, (B, mk)), "logical": (logical, (B, mk)),
            "counts": (counts, (B,)), "keep": (keep, (B, mk, N, G, Sq)),
            "kv_len": (kv_len, (B,))}
    if quantized:
        want.update(k_scale=(k_scale, (P, N)), v_scale=(v_scale, (P, N)))
    for name, (t, shape) in want.items():
        dt = torch.float32 if name.endswith("scale") else torch.int32
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = [qq, k_pool, v_pool, page_ids, logical, counts, keep, kv_len]
    if quantized:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != qq.device:
            raise ValueError(f"all inputs must be on {qq.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    return quantized


def hdp_paged_fum_decode(qq, k_pool, v_pool, page_ids, logical, counts,
                         keep, kv_len, *, approx: bool = True,
                         int_bits: int = 4, frac_bits: int = 12,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """qq [B,N,G,Sq,hd] fp32 fixed-grid queries; k/v_pool [P,ps,N,hd]
    page pools (int8 codes with ``k_scale``/``v_scale`` [P,N] fp32, or
    fp32 values without); page_ids/logical [B,mk] int32 pool id / slot
    position of each kept page, ascending and scratch-0-padded past
    ``counts`` [B] int32; keep [B,mk,N,G,Sq] int32 per-row keep; kv_len
    [B] int32 valid KV extent of query row 0 (row j's is kv_len + j).
    Returns [B,N,G,Sq,hd] fp32; the caller applies the head gate. Pages
    absent from ``page_ids[:, :counts]`` are never read."""
    quantized = _check(qq, k_pool, v_pool, page_ids, logical, counts, keep,
                       kv_len, k_scale, v_scale)
    if qq.device.type == "cpu":
        return hdp_paged_fum_decode_ref(
            qq, k_pool, v_pool, page_ids, logical, counts, keep, kv_len,
            approx=approx, int_bits=int_bits, frac_bits=frac_bits,
            k_scale=k_scale, v_scale=v_scale)
    if qq.device.type != "cuda":
        raise ValueError(f"no kernel for device {qq.device}")
    B, N, G, Sq, hd = qq.shape
    P, ps = k_pool.shape[:2]
    # the kernel loads four pool elements at a time
    if hd % 4 or any(t.data_ptr() % (4 * t.element_size())
                     for t in (k_pool, v_pool)):
        raise ValueError(f"the kernel needs hd % 4 == 0 and pools aligned "
                         f"to four elements, got hd={hd}")
    lib = _library()
    out = torch.empty_like(qq)
    vp = ctypes.c_void_p
    with torch.cuda.device(qq.device):
        stream = torch.cuda.current_stream(qq.device).cuda_stream
        err = lib.hdp_paged_fum_decode_launch(
            vp(qq.data_ptr()), vp(k_pool.data_ptr()), vp(v_pool.data_ptr()),
            vp(k_scale.data_ptr() if quantized else 0),
            vp(v_scale.data_ptr() if quantized else 0),
            vp(page_ids.data_ptr()), vp(logical.data_ptr()),
            vp(counts.data_ptr()), vp(keep.data_ptr()),
            vp(kv_len.data_ptr()), vp(out.data_ptr()),
            B, N, G, Sq, hd, ps, page_ids.shape[1], P, int(quantized),
            int(approx), int_bits, frac_bits,
            ctypes.c_float(1.0 / (hd ** 0.5)), vp(stream))
    if err != 0:
        # e.g. a G*Sq x hd x ps block over the 227 KB of shared memory
        msg = lib.hdp_paged_fum_decode_error_string(err).decode()
        raise RuntimeError(f"hdp_paged_fum_decode launch failed for "
                           f"G*Sq={G * Sq}, hd={hd}, ps={ps}: {msg}")
    hdp_paged_fum_decode.launches += 1
    return out


hdp_paged_fum_decode.launches = 0
