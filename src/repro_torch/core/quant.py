"""Fixed-point quantization, integer/fraction split and the int8 pool grid.

PyTorch counterpart of ``repro.core.quant``. Values stay in float tensors
snapped to the fixed-point grid, so the integer/fraction decomposition
and the scout product are exact (int32-representable). ``torch.round``
rounds half to even, as ``jnp.round`` does; nothing here rounds with
``floor(x + 0.5)``.

The serving pool stores int8 *codes* on the static power-of-two grid
``pool_scale(int_bits)`` plus a per-page scale. Code -128 is never
produced by encoding: it is the position-granular poison sentinel
(``decode_pool`` maps it to NaN, ``pool_view_finite`` to 0). A NaN page
scale poisons every dequant of that page while the scout view stays
finite.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distribution.collectives import group_max, group_mean

F32 = torch.float32

#: reserved int8 code marking a poisoned position (never produced by
#: ``encode_pool``; decodes to NaN, scout-views to 0).
POISON_CODE = -128

#: grid of the quantized-fraction scout copy a self-speculative draft
#: scores with (fractions kept to 2^-6)
FRAC_SCOUT_SCALE = 64.0


def quantize_fixed(x: torch.Tensor, int_bits: int = 4,
                   frac_bits: int = 12) -> torch.Tensor:
    """Quantize to signed fixed point Q(int_bits).(frac_bits), keeping
    x's float dtype. Range [-2^int_bits, 2^int_bits - 2^-frac_bits]."""
    scale = 2.0 ** frac_bits
    lo = -(2.0 ** int_bits)
    hi = 2.0 ** int_bits - 2.0 ** (-frac_bits)
    q = torch.round(x * scale) / scale
    return torch.clamp(q, lo, hi)


def int_frac_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x == I + F with I = trunc(x) and F in (-1, 1)."""
    i = torch.trunc(x)
    return i, x - i


def quantize_and_split(x: torch.Tensor, int_bits: int = 4,
                       frac_bits: int = 12):
    """quantize_fixed followed by int_frac_split; returns (xq, I, F)."""
    xq = quantize_fixed(x, int_bits, frac_bits)
    i, f = int_frac_split(xq)
    return xq, i, f


def pool_int_bits(hdp) -> int:
    """Integer bits of the pool grid: the HDP grid when the scout runs,
    a Q4 default for HDP-off paged serving."""
    return hdp.int_bits if hdp is not None and hdp.enabled else 4


def pool_scale(int_bits: int = 4) -> float:
    """Static power-of-two step of the int8 pool grid: +/-127 codes span
    (just under) the fixed-point range +/-2^int_bits."""
    return 2.0 ** (int_bits - 7)


def encode_pool(x: torch.Tensor, int_bits: int = 4) -> torch.Tensor:
    """Float values -> int8 pool codes on the static grid, clamped to
    [-127, 127] (-128 stays reserved for poison)."""
    s = pool_scale(int_bits)
    return torch.clamp(torch.round(x.to(F32) / s), -127, 127).to(torch.int8)


def decode_pool(codes: torch.Tensor, scale) -> torch.Tensor:
    """int8 codes (+ broadcastable per-page scale) -> fp32 values; the
    sentinel decodes to NaN and a NaN scale poisons the whole page."""
    c = codes.to(F32)
    c = torch.where(codes == POISON_CODE, torch.full_like(c, float("nan")), c)
    return c * torch.as_tensor(scale, dtype=F32, device=codes.device)


def pool_view_finite(codes: torch.Tensor, int_bits: int = 4) -> torch.Tensor:
    """Finite static-grid view of pool codes (poison -> 0, scale = grid):
    what the stage-1 scout reads."""
    c = torch.where(codes == POISON_CODE, torch.zeros_like(codes), codes)
    return c.to(F32) * pool_scale(int_bits)


def roundtrip_pool(x: torch.Tensor, int_bits: int = 4) -> torch.Tensor:
    """Snap x to exactly what an encode/decode round trip preserves
    (applied to K/V at prefill by quantized-pool engines)."""
    s = pool_scale(int_bits)
    return torch.clamp(torch.round(x.to(F32) / s), -127, 127) * s


def absmax_page_scale(x: torch.Tensor, int_bits: int = 4) -> torch.Tensor:
    """Per-page per-kv-head calibrated absmax scale of a page-shaped slab
    [..., ps, N, hd]: s = max|x| / 127 over the page's positions and head
    dim, so the page's largest value maps to code +/-127. All-zero pages
    take the static grid step (a NaN scale is the freed-page poison and
    never comes from encoding). Returns [..., N]. The division is a
    product with the fp32 reciprocal of 127, as XLA compiles the
    reference's."""
    m = x.to(F32).abs().amax(dim=(-3, -1))
    s0 = torch.full_like(m, pool_scale(int_bits))
    return torch.where(m > 0, m * torch.full_like(m, 1.0 / 127.0), s0)


def encode_pool_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float values -> int8 pool codes under an explicit (per-page) scale
    broadcastable against x, clamped to [-127, 127] as on the grid."""
    return torch.clamp(torch.round(x.to(F32) / scale.to(F32)),
                       -127, 127).to(torch.int8)


#: largest |x| that float8_e4m3fn encodes (448) plus half its last step:
#: values above it are NaN in the reference's cast, where torch saturates
FP8_E4M3_LIMIT = 464.0


def to_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x -> float8_e4m3fn as the reference's cast does it: round to
    nearest even, and NaN for |x| > 464 (448 is the largest finite code;
    464 is the midpoint to the next step, and ties go to the even 448).
    torch's own cast saturates those to +/-448 instead, so they are
    mapped to NaN before it."""
    nan = torch.full_like(x, float("nan"))
    return torch.where(x.abs() > FP8_E4M3_LIMIT, nan, x).to(
        torch.float8_e4m3fn)


def scout_int_codes(x: torch.Tensor, int_bits: int = 4,
                    frac_bits: int = 12) -> torch.Tensor:
    """int8 integer-scout codes of K (trunc of the fixed-point grid): the
    write-time copy an unquantized pool stores beside its pages."""
    xq = quantize_fixed(x.to(F32), int_bits, frac_bits)
    return torch.trunc(xq).to(torch.int8)


def scout_frac_codes(x: torch.Tensor, int_bits: int = 4,
                     frac_bits: int = 12) -> torch.Tensor:
    """int8 quantized-fraction scout codes of K (on the FRAC_SCOUT_SCALE
    grid): the write-time copy a speculating unquantized pool stores."""
    xq = quantize_fixed(x.to(F32), int_bits, frac_bits)
    f = xq - torch.trunc(xq)
    return torch.round(f * FRAC_SCOUT_SCALE).to(torch.int8)


def calib_scale(x: torch.Tensor, int_bits: int, mode: str) -> torch.Tensor:
    """Per-tensor scale mapping x onto the fixed-point grid ("max" |
    "rms" | "none"); scores are divided by s_q*s_k afterwards."""
    if mode == "none":
        return torch.ones((), dtype=F32, device=x.device)
    xf = x.to(F32)
    if mode == "max":
        # the whole batch's maximum, where a mesh step holds some rows
        m = group_max(xf.abs().max())
        # tensor / tensor: a python scalar on the left would become
        # reciprocal(m) * c, which rounds differently from jnp's division
        # (a device fill, not a host copy: a captured decode graph holds it)
        c = torch.full((), (2.0 ** int_bits) * 0.999, dtype=F32,
                       device=x.device)
        return c / torch.clamp(m, min=1e-6)
    if mode == "rms":
        r = torch.sqrt(group_mean(torch.sum(xf * xf) * (1.0 / xf.numel())))
        c = torch.full((), 2.0 ** max(int_bits - 2, 0), dtype=F32,
                       device=x.device)
        return c / torch.clamp(r, min=1e-6)
    raise ValueError(f"unknown calibration mode {mode!r}")
