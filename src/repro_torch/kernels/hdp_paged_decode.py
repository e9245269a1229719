"""Gather-free paged FUM decode: wrapper of the CUDA kernel.

``hdp_paged_fum_decode`` is the port of the TPU kernel
``repro/kernels/hdp_paged_decode.py:hdp_paged_fum_decode``: stages 2 and
3 of every HDP decode layer, streaming only the pool pages that survived
the scout (see ``csrc/hdp_paged_decode.cu`` for the kernel and its
design). On a CUDA tensor the wrapper launches the kernel or raises; on
a CPU tensor it runs the plain version ``ref.hdp_paged_fum_decode_ref``.

The kernel splits each (b, n)'s listed pages across ``S`` blocks (a
page goes to the block of its logical slot mod S, so a query row's sums
group the same whatever else the list holds: a multi-query verify row
equals the single step at its position) and merges their partial
softmaxes in a second pass; ``fum_splits`` picks S from shapes and the
SM count alone (about one block per SM), so no call waits on
``counts``. S = 1 ("single") writes the output in one pass; S > 1
("split") adds the merge. The G*Sq query rows split over blocks of at
most ``ROWS_PER_THREAD * (256 // max(ps, hd))`` rows, so any verify
width runs. ``hdp_paged_fum_decode.launches`` counts
wrapper launches (the plain version does not count),
``.launches_by_path`` them per mode and ``.launches_by_format`` per pool
format; a call under CUDA graph capture
counts once, where it records the kernel, and the graph's replays do
not call the wrapper. ``hdp_paged_fum_decode.runs`` is the kernel's own
count on the card (``build.RunCounter``): every run of
``fum_decode_kernel``, a graph's replays included.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import hdp_paged_fum_decode_ref

#: the kernel's two modes: one pass, or pages split across blocks + merge
PATHS = ("single", "split")
#: pool formats the kernel takes, (K dtype, V dtype, with scales) -> the
#: C interface's code: int8 codes; int8 K and fp8 e4m3 V (scale 1.0);
#: unquantized pools in fp32 or bf16 (K snapped to the fixed-point grid)
FORMATS = {(torch.int8, torch.int8, True): 0,
           (torch.int8, torch.float8_e4m3fn, True): 1,
           (torch.float32, torch.float32, False): 2,
           (torch.bfloat16, torch.bfloat16, False): 3}
#: the formats' names, by code (``launches_by_format``'s keys)
FORMAT_NAMES = ("int8", "fp8_v", "fp32", "bf16")
#: the most query rows one thread takes: a block takes at most
#: this * (256 // max(ps, hd)) of the G*Sq rows, and more split over blocks
ROWS_PER_THREAD = 16

_lib: Optional[ctypes.CDLL] = None   # loaded (and built) at first launch
_n_sm: Dict[int, int] = {}           # SM count per CUDA device index


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("hdp_paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hdp_paged_fum_decode_launch.argtypes = \
            [p] * 13 + [i] * 13 + [ctypes.c_float, p]
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
    fmt = FORMATS.get((k_pool.dtype, v_pool.dtype, quantized))
    if fmt is None:
        raise ValueError(
            ("int8 K pools with scales expected (V int8 or float8_e4m3fn)"
             if quantized else "float32 pools expected (or bfloat16 K and "
             "V) without scales") + f", got {k_pool.dtype}/{v_pool.dtype}")
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
    return fmt


def fum_splits(B: int, N: int, mk: int, n_sm: int) -> int:
    """Blocks per (b, n) row of the FUM kernel: enough for about one block
    per SM (``n_sm // (B*N)``), at most one per page slot (``mk``), at
    least 1. A function of shapes alone: the kernel spreads the listed
    pages over the S blocks itself, so no host sync on ``counts``."""
    return max(1, min(mk, n_sm // max(1, B * N)))


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def hdp_paged_fum_decode(qq, k_pool, v_pool, page_ids, logical, counts,
                         keep, kv_len, *, approx: bool = True,
                         int_bits: int = 4, frac_bits: int = 12,
                         k_scale=None, v_scale=None,
                         splits: Optional[int] = None) -> torch.Tensor:
    """qq [B,N,G,Sq,hd] fp32 fixed-grid queries; k/v_pool [P,ps,N,hd]
    page pools (int8 K codes and int8 or float8_e4m3fn V with
    ``k_scale``/``v_scale`` [P,N] fp32, or fp32 or bf16 values without,
    see ``FORMATS``); page_ids/logical [B,mk] int32 pool id / slot
    position of each kept page, ascending and scratch-0-padded past
    ``counts`` [B] int32; keep [B,mk,N,G,Sq] int32 per-row keep; kv_len
    [B] int32 valid KV extent of query row 0 (row j's is kv_len + j).
    Returns [B,N,G,Sq,hd] fp32; the caller applies the head gate. Pages
    absent from ``page_ids[:, :counts]`` are never read. ``splits`` forces
    S (1: the one-pass kernel), to hold the modes against each other; by
    default the wrapper takes ``fum_splits``'s choice."""
    fmt = _check(qq, k_pool, v_pool, page_ids, logical, counts, keep,
                 kv_len, k_scale, v_scale)
    quantized = k_scale is not None
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    if qq.device.type == "cpu":
        return hdp_paged_fum_decode_ref(
            qq, k_pool, v_pool, page_ids, logical, counts, keep, kv_len,
            approx=approx, int_bits=int_bits, frac_bits=frac_bits,
            k_scale=k_scale, v_scale=v_scale)
    if qq.device.type != "cuda":
        raise ValueError(f"no kernel for device {qq.device}")
    B, N, G, Sq, hd = qq.shape
    P, ps = k_pool.shape[:2]
    mk = page_ids.shape[1]
    # the kernel loads four pool elements at a time (sixteen int8 codes
    # where hd and the pools allow)
    if hd % 4 or not 4 <= hd <= 128 or any(
            t.data_ptr() % (4 * t.element_size()) for t in (k_pool, v_pool)):
        raise ValueError(f"the kernel needs hd a multiple of 4 up to 128 and "
                         f"pools aligned to four elements, got hd={hd}")
    if not 1 <= ps <= 128:
        raise ValueError(f"the kernel takes pages of 1 to 128 positions, got "
                         f"ps={ps}")
    S = splits if splits is not None else fum_splits(B, N, mk,
                                                     _sm_count(qq.device))
    lib = _library()
    out = torch.empty_like(qq)
    part = torch.empty((B, N, S, G * Sq, hd + 2) if S > 1 else (0,),
                       dtype=torch.float32, device=qq.device)
    vp = ctypes.c_void_p
    with torch.cuda.device(qq.device):
        stream = torch.cuda.current_stream(qq.device).cuda_stream
        err = lib.hdp_paged_fum_decode_launch(
            vp(qq.data_ptr()), vp(k_pool.data_ptr()), vp(v_pool.data_ptr()),
            vp(k_scale.data_ptr() if quantized else 0),
            vp(v_scale.data_ptr() if quantized else 0),
            vp(page_ids.data_ptr()), vp(logical.data_ptr()),
            vp(counts.data_ptr()), vp(keep.data_ptr()),
            vp(kv_len.data_ptr()), vp(out.data_ptr()), vp(part.data_ptr()),
            vp(hdp_paged_fum_decode.runs.tensor(qq.device).data_ptr()),
            B, N, G, Sq, hd, ps, mk, P, S, fmt,
            int(approx), int_bits, frac_bits,
            ctypes.c_float(1.0 / (hd ** 0.5)), vp(stream))
    if err != 0:
        # e.g. the card refusing the block's shared memory or its grid
        msg = lib.hdp_paged_fum_decode_error_string(err).decode()
        raise RuntimeError(f"hdp_paged_fum_decode launch failed for "
                           f"G*Sq={G * Sq}, hd={hd}, ps={ps}, S={S}: {msg}")
    hdp_paged_fum_decode.launches += 1
    hdp_paged_fum_decode.launches_by_path["single" if S == 1 else "split"] += 1
    hdp_paged_fum_decode.launches_by_format[FORMAT_NAMES[fmt]] += 1
    return out


hdp_paged_fum_decode.launches = 0
hdp_paged_fum_decode.launches_by_path = dict.fromkeys(PATHS, 0)
hdp_paged_fum_decode.launches_by_format = dict.fromkeys(FORMAT_NAMES, 0)
hdp_paged_fum_decode.runs = build.RunCounter()
