"""Integer scout: wrapper of the CUDA kernels.

``hdp_scout`` is the port of the TPU kernel
``repro/kernels/hdp_scout.py:hdp_scout``: |IQ·IKᵀ| pooled per block into
theta, the row-balanced threshold and keep mask, and theta_head. On a
CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor it
runs the plain version ``ref.hdp_scout_plain``.

Two kernels serve CUDA tensors, picked by ``scout_path`` from the call's
shapes alone: the int8 tensor-core kernel (``csrc/hdp_scout_tc.cu``:
``wgmma`` s8 products on int8 copies made by a pre-pass) for hd a
multiple of 32 up to 128, or 112 (zamba2-7b's: the copies' rows are
zero-padded to 128 bytes), with blocks of 64 or 128, the aligned
prefills' shapes; the ``__dp4a`` kernel (``csrc/hdp_scout.cu``) for the
rest (the reduced configs' hd 16 and 2×2 blocks). Both are exact: theta,
keep and theta_head equal the plain version's bit for bit.
``hdp_scout.launches`` counts kernel launches (the plain version does not
count), ``.launches_by_path`` them per path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hdp_scout_plain, scout_coefficients

#: the two kernels behind the wrapper
PATHS = ("tensor_core", "dp4a")
#: block sizes (rows and columns) the tensor-core kernel takes
TC_BLOCKS = (64, 128)
#: head size the tensor-core kernel takes besides the multiples of 32,
#: run as hd 128 on copies whose last 16 columns are zero
TC_PADDED_HD = 112
#: the CUDA source (and C prefix) of each path
SOURCES = {"tensor_core": "hdp_scout_tc", "dp4a": "hdp_scout"}

_libs: Dict[str, ctypes.CDLL] = {}   # loaded (and built) at first launch


def _library(path: str) -> ctypes.CDLL:
    if path not in _libs:
        name = SOURCES[path]
        lib = build.load(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(lib, f"{name}_launch")
        ll = ctypes.c_longlong
        fn.argtypes = ([p] * 11 + [i] * 7 + [ll] * 6 if path == "tensor_core"
                       else [p] * 8 + [i] * 6) + [i] * 2 + [f] * 2 + [p]
        fn.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        _libs[path] = lib
    return _libs[path]


def _rows_aligned(t: torch.Tensor) -> bool:
    """d contiguous and every row of four-value groups 16-byte aligned."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(st % 4 == 0 for st in t.stride()[:3])


def scout_path(hd: int, block_q: int, block_k: int) -> str:
    """Which kernel serves a CUDA call, from shapes alone: "tensor_core"
    for hd a multiple of 32 up to 128 or ``TC_PADDED_HD`` and block_q,
    block_k in ``TC_BLOCKS``; else "dp4a" for hd a multiple of 4 up to
    256 and blocks of 1 to 128 rows and columns; a shape that neither
    takes raises ValueError."""
    if (hd % 32 == 0 and 32 <= hd <= 128 or hd == TC_PADDED_HD) \
            and block_q in TC_BLOCKS and block_k in TC_BLOCKS:
        return "tensor_core"
    if hd % 4 or not 4 <= hd <= 256:
        raise ValueError(f"the scout kernels need hd a multiple of 4 up to "
                         f"256, got {hd}")
    if not (1 <= block_q <= 128 and 1 <= block_k <= 128):
        raise ValueError(f"the scout kernels take blocks up to 128x128, got "
                         f"{block_q}x{block_k}")
    return "dp4a"


def hdp_scout(iq, ik, *, rho_b: float, block_q: int = 128,
              block_k: int = 128, causal: bool = True,
              chunk_blocks: int = 8, path: Optional[str] = None):
    """iq/ik [B,H,S,hd] fp32 integer parts -> (theta [B,H,nq,nk] fp32,
    keep [B,H,nq,nk] bool, theta_head [B,H] fp32).

    ``chunk_blocks`` is the TPU kernel's KV chunk per grid step; the
    result does not depend on it (the CUDA kernels walk one KV block at a
    time). On the card every value must be an integer in [-128, 127]: a
    q tile that reads anything else gets NaN theta and no kept block.
    ``path`` forces "dp4a" on a shape that ``scout_path`` gives the
    tensor-core kernel, to hold the two kernels against each other; by
    default the wrapper takes ``scout_path``'s choice."""
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
    if path not in (None,) + PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    build.refuse_trace("hdp_scout", iq)
    if iq.device.type == "cpu":
        return hdp_scout_plain(iq, ik, rho_b=rho_b, block_q=block_q,
                               block_k=block_k, causal=causal,
                               chunk_blocks=chunk_blocks)
    if iq.device.type != "cuda":
        raise ValueError(f"no kernel for device {iq.device}")
    B, H, Sq, hd = iq.shape
    chosen = scout_path(hd, block_q, block_k)
    if path not in (None, chosen, "dp4a"):
        raise ValueError(f"path {path!r} does not take hd={hd}, blocks "
                         f"{block_q}x{block_k} (scout_path: {chosen!r})")
    path = path or chosen
    Sk = ik.shape[2]
    # the kernels read four values per load (16-byte aligned rows); the
    # tensor-core path's pre-pass reads any such strides, the dp4a kernel
    # contiguous rows
    if path == "dp4a" or not all(_rows_aligned(t) for t in (iq, ik)):
        iq, ik = iq.contiguous(), ik.contiguous()
    if not all(_rows_aligned(t) for t in (iq, ik)):
        raise ValueError("the scout kernels need 16-byte aligned inputs")
    nq, nk = -(-Sq // block_q), -(-Sk // block_k)
    BH = B * H
    dev = iq.device
    theta = torch.empty((B, H, nq, nk), dtype=torch.float32, device=dev)
    keep = torch.empty((B, H, nq, nk), dtype=torch.bool, device=dev)
    theta_head = torch.empty((B, H), dtype=torch.float32, device=dev)
    # per-head scratch, zeroed in one allocation: the exact theta sum
    # (row 0, 64-bit), q tiles done and the bad-input flag (rows 1 and 2,
    # whose first BH 32-bit words the kernels use)
    scratch = torch.zeros((3, BH), dtype=torch.int64, device=dev)
    use_max, c_ext, c_mean = scout_coefficients(rho_b)
    lib = _library(path)
    name = SOURCES[path]
    vp = ctypes.c_void_p
    ptrs = [vp(iq.data_ptr()), vp(ik.data_ptr())]
    if path == "tensor_core":
        # the pre-pass's int8 copies, padded to whole blocks (and hd 112
        # to rows of 128 bytes), and its per-block bad-input flags; every
        # byte is written before it is read
        hdp = -(-hd // 32) * 32
        iq8 = torch.empty((BH, nq * block_q, hdp), dtype=torch.int8,
                          device=dev)
        ik8 = torch.empty((BH, nk * block_k, hdp), dtype=torch.int8,
                          device=dev)
        flags = torch.empty(BH * (nq + nk), dtype=torch.int32, device=dev)
        ptrs += [vp(iq8.data_ptr()), vp(ik8.data_ptr()),
                 vp(flags.data_ptr())]
    ptrs += [vp(theta.data_ptr()), vp(keep.data_ptr()),
             vp(theta_head.data_ptr()), vp(scratch[0].data_ptr()),
             vp(scratch[1].data_ptr()), vp(scratch[2].data_ptr())]
    dims = [BH, Sq, Sk, hd, block_q, block_k]
    if path == "tensor_core":
        dims = [B, H, Sq, Sk, hd, block_q, block_k, *iq.stride()[:3],
                *ik.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *ptrs, *dims, int(causal), int(use_max), ctypes.c_float(c_ext),
            ctypes.c_float(c_mean), vp(stream))
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"hdp_scout ({path}) launch failed for nk={nk}, "
                           f"blocks {block_q}x{block_k}, hd={hd}: {msg}")
    hdp_scout.launches += 1
    hdp_scout.launches_by_path[path] += 1
    return theta, keep, theta_head


hdp_scout.launches = 0
hdp_scout.launches_by_path = dict.fromkeys(PATHS, 0)
