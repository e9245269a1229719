"""Integer scout: wrapper of the CUDA kernel.

``hdp_scout`` is the port of the TPU kernel
``repro/kernels/hdp_scout.py:hdp_scout``: |IQ·IKᵀ| pooled per block into
theta, the row-balanced threshold and keep mask, and theta_head (see
``csrc/hdp_scout.cu`` for the kernel and its design). On a CUDA tensor
the wrapper launches the kernel or raises; on a CPU tensor it runs the
plain version ``ref.hdp_scout_plain``. ``hdp_scout.launches`` counts
kernel launches (the plain version does not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hdp_scout_plain, scout_coefficients

_lib: Optional[ctypes.CDLL] = None   # loaded (and built) at first launch


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("hdp_scout")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hdp_scout_launch.argtypes = \
            [p] * 8 + [i] * 8 + [ctypes.c_float] * 2 + [p]
        lib.hdp_scout_launch.restype = i
        lib.hdp_scout_error_string.argtypes = [i]
        lib.hdp_scout_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def hdp_scout(iq, ik, *, rho_b: float, block_q: int = 128,
              block_k: int = 128, causal: bool = True,
              chunk_blocks: int = 8):
    """iq/ik [B,H,S,hd] fp32 integer parts -> (theta [B,H,nq,nk] fp32,
    keep [B,H,nq,nk] bool, theta_head [B,H] fp32).

    ``chunk_blocks`` is the TPU kernel's KV chunk per grid step; the
    result does not depend on it (the CUDA kernel walks one KV block at a
    time). On the card every value must be an integer in [-128, 127]: a
    q tile that reads anything else gets NaN theta and no kept block."""
    if iq.dim() != 4 or ik.dim() != 4 or iq.shape[:2] != ik.shape[:2] \
            or iq.shape[3] != ik.shape[3]:
        raise ValueError(f"iq/ik must be [B,H,S,hd] with one B, H and hd, "
                         f"got {tuple(iq.shape)} and {tuple(ik.shape)}")
    if iq.dtype != torch.float32 or ik.dtype != torch.float32:
        raise ValueError(f"iq/ik must be float32, got {iq.dtype}/{ik.dtype}")
    if iq.device != ik.device:
        raise ValueError(f"iq on {iq.device}, ik on {ik.device}")
    if block_q < 1 or block_k < 1:
        raise ValueError("block sizes must be >= 1")
    if iq.device.type == "cpu":
        return hdp_scout_plain(iq, ik, rho_b=rho_b, block_q=block_q,
                               block_k=block_k, causal=causal,
                               chunk_blocks=chunk_blocks)
    if iq.device.type != "cuda":
        raise ValueError(f"no kernel for device {iq.device}")
    B, H, Sq, hd = iq.shape
    Sk = ik.shape[2]
    iq, ik = iq.contiguous(), ik.contiguous()
    # the kernel packs four values per load (16-byte aligned rows)
    if hd % 4 or any(t.data_ptr() % 16 for t in (iq, ik)):
        raise ValueError(f"the kernel needs hd % 4 == 0 and 16-byte "
                         f"aligned inputs, got hd={hd}")
    if block_q > 128 or block_k > 128:
        raise ValueError(f"the kernel takes blocks up to 128x128, got "
                         f"{block_q}x{block_k}")
    nq, nk = -(-Sq // block_q), -(-Sk // block_k)
    BH = B * H
    dev = iq.device
    theta = torch.empty((B, H, nq, nk), dtype=torch.float32, device=dev)
    keep = torch.empty((B, H, nq, nk), dtype=torch.bool, device=dev)
    theta_head = torch.empty((B, H), dtype=torch.float32, device=dev)
    # per-head scratch, zeroed in one allocation: the exact theta sum
    # (row 0, 64-bit), q tiles done and the bad-input flag (rows 1 and 2,
    # whose first BH 32-bit words the kernel uses)
    scratch = torch.zeros((3, BH), dtype=torch.int64, device=dev)
    use_max, c_ext, c_mean = scout_coefficients(rho_b)
    lib = _library()
    vp = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hdp_scout_launch(
            vp(iq.data_ptr()), vp(ik.data_ptr()), vp(theta.data_ptr()),
            vp(keep.data_ptr()), vp(theta_head.data_ptr()),
            vp(scratch[0].data_ptr()), vp(scratch[1].data_ptr()),
            vp(scratch[2].data_ptr()),
            BH, Sq, Sk, hd, block_q, block_k, int(causal), int(use_max),
            ctypes.c_float(c_ext), ctypes.c_float(c_mean), vp(stream))
    if err != 0:
        msg = lib.hdp_scout_error_string(err).decode()
        raise RuntimeError(f"hdp_scout launch failed for nk={nk}, "
                           f"blocks {block_q}x{block_k}, hd={hd}: {msg}")
    hdp_scout.launches += 1
    return theta, keep, theta_head


hdp_scout.launches = 0
