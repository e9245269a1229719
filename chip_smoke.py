#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and nvcc, and imports only the port (``src/repro_torch``),
never JAX nor the JAX package. Phases:

1. environment — card name and power limit (nvidia-smi);
2. build — every CUDA source (seven: the FUM decode, the scout's int8
   tensor-core and dp4a kernels, and the tensor-core and tile kernels of
   block-sparse and flash attention), one nvcc each, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the reference tests' small shapes (2x2 blocks and ragged S
   included) and at qwen2-1.5b's full-width shapes: the paged FUM
   decode on int8, fp32, fp8-V (int8 K, fp8 e4m3 V) and bf16 pools (the
   last two also at granite-8b's shape), at Sq 1, 3 and 8 (the verify
   shape; 48 rows split over two row blocks), split across blocks and in
   one pass, each with its poison checks;
   the integer scout on both of its paths (theta, keep and theta_head
   bit-equal, ragged S, non-causal, rho < 0, int8 extremes, and the
   bad-input NaN); the block-sparse FUM attention on the
   prefill and the paged-decode routes and flash attention (atol = rtol
   = 1e-4 with fp32 V, 2e-2 with bf16 V) on both of their paths, the
   tensor-core path also at S 4000, hd 64, non-causal, with a gated head
   and with a q tile that lists no block (each call's path asserted);
   the no-read poison checks;
4. aligned prefill — qwen2-1.5b at full width (bf16, seeded weights),
   B 2, S 4096, through ``registry.apply_prefill(..., None)``: HDP on
   resolves to ``pallas_hdp_block`` and launches the scout and block
   kernels once per layer, HDP off resolves to ``pallas_flash`` and
   launches flash once per layer, scout, block and flash on the
   tensor-core path; kernel vs plain at the path's own
   inputs; the reduced config's logits on the card equal the CPU's, in
   fp32 and in bf16, its scout on the dp4a path;
5. serving — the same weights serve 8 requests through
   ``Engine.submit``/``run``, first eagerly (``cuda_graph=False``, each
   FUM call recorded and the busiest held against the plain version),
   then on the decode step's CUDA graph at horizons 1 and 4 (the main
   path): identical tokens, the FUM kernel once per layer per decode
   step (pages split across blocks), as the kernel's own count of its
   runs on the card (``.runs``) shows over every serve, graph replays
   included, and the graph faster than the eager steps;
   ``Engine(attn="pallas_hdp_block")`` the block kernel on its tile
   path, eagerly and graphed (counted on the card alike), with
   identical tokens; prompts of 2,500
   and 4,000 tokens through chunked prefill; the reduced config graphed
   on the card, with one prompt chunked, must give the CPU's tokens;
5b. granite-8b at full width (36 layers, bf16, 16 GB of seeded weights
   built on the card): 8 requests of up to 4,096 prompt tokens, 32 new
   tokens each, on the int8 grid pool, the fp8_v pool and the bf16
   ("fp32") pool through the FUM kernel, the absmax pool through the
   plain stage 3, HDP off on the paged and the dense layout, and HDP on
   on the dense layout (``xla_hdp``); each eagerly and graphed at
   horizon 4 with equal tokens, tok/s, backends, pool format and cache
   bytes per token printed, the FUM kernel's runs counted on the card;
   then the reduced config on each route, card vs CPU;
5c. windowed decode: h2o-danube-1.8b at full width cut to 4 layers,
   its window cut to 512 under prompts of 600-1,000 tokens (decode on
   ``paged_hdp_decode``), eager and graphed equal; the reduced config
   (window 16) card vs CPU;
5d. prefix cache and speculative decode, qwen2-1.5b at full width (run
   right after phase 5, on its weights): a 1,024-token shared prompt
   (a warm-up request, then 6 hits with tails of 32-480 tokens through
   chunked prefill and 2 full hits of its first 512 and 1,024 tokens)
   through the graphed engine at horizon 4 with the prefix cache and
   without, head pruning off: equal tokens, 8 hits, 2 COWs, a drained
   pool, prefill_s hot against cold, then hot on the stock config;
   phase 5's traffic by speculative decode, graphed, at draft lengths 4
   and 8 (one CUDA graph per round width), tokens equal to the graphed
   horizon-1 engine's, the FUM kernel 28 times per verify and never in
   a draft step (the wrappers' counts over each capture, and the
   kernel's count on the card at both draft lengths, read before and
   after each round and so split by the round's width), and the
   kernel against its plain version at the path's verify call that
   listed the most pages, each of its rows bit-equal to the single step
   at that row's position; the bf16 ("fp32") pool with its fraction
   copy cut to 8 layers, spec equal to horizon 1; the reduced config
   with both features, card (graphed) vs CPU;
6. timing — each kernel and its plain version at the main path's shape
   (CUDA events around device work only, L2 flushed between launches)
   beside its bound and, where one PyTorch call computes the same
   function, that call; the tile paths at the calls that take them (the
   decode route's block call; flash in fp32 at the prefill's shape); the
   scout's dp4a kernel and the FUM decode in one pass (the earlier
   designs) at the same inputs as their successors; the FUM decode at
   the verify shape (Sq 4 and 8, the timing case's widths); its fp8-V
   and bf16 pool variants at the int8 timing case's values.

Prints the per-kernel JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: NVIDIA H100 SXM data-sheet peaks (dense, at the full 700 W limit)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
INT8_OPS_S = 1979e12
ATOL = RTOL = 1e-4   # fp32 accumulation in both; only the sum order differs
TOL_BF16 = 2e-2      # p is rounded to bf16 before P.V in both
THETA_RTOL = 1e-5
N_LAYERS_QWEN = 28
SOURCES = ("hdp_paged_decode", "hdp_scout", "hdp_scout_tc", "hdp_block_attn",
           "hdp_block_attn_tc", "flash_attention", "flash_attention_tc")
PREFILL_B, PREFILL_S = 2, 4096
#: why a kernel has no library_ms: no single PyTorch call computes it
NO_LIBRARY_CALL = {
    "hdp_paged_fum_decode": "no PyTorch call attends over a paged pool's "
                            "listed pages with the FUM scores",
    "hdp_scout": "no PyTorch call pools |IQ.IK^T| per block and applies "
                 "the row threshold",
    "hdp_block_sparse_attention": "no PyTorch call attends over listed "
                                  "blocks with the FUM scores QK^T - FQ.FK^T",
}


#: worst max |kernel - plain| of each kernel entry of the scout, block and
#: flash wrappers, filled by check_scout, check_block and check_flash
#: (entry: the wrapper's name, "[<path>]" added off the tensor-core path)
ERRS = {}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg=""):
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1
def phase_env(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(smi_line)
    return name, smi_line


# ------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(SOURCES)
    log(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, rec in built.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


# ------------------------------------------------------------ phase 3
#: FUM pool formats: int8 codes, int8 K + fp8 V pages (scale 1.0), and
#: unquantized pools in fp32 and in bf16 (the model dtype at full width)
FUM_FORMATS = ("int8", "fp32", "fp8_v", "bf16")
#: the tolerance of each format against the plain version: p is rounded
#: to bf16 before p.V on a bf16 pool, relative to each block's running
#: max when the pages are split, so the roundings differ there
FUM_TOL = {"int8": ATOL, "fp32": ATOL, "fp8_v": ATOL, "bf16": TOL_BF16}


def make_case(torch, *, B, N, G, Sq, hd, ps, nP, fmt, live, seed):
    """Paged FUM decode inputs the way the serving path builds them: a
    pool in format ``fmt`` whose rows own distinct pages, a keep mask,
    and the fetch list compressed by the model's own ``_fetch_list``."""
    from repro_torch.core.quant import pool_scale, quantize_fixed, to_fp8_e4m3
    from repro_torch.models.attention import _fetch_list
    g = torch.Generator().manual_seed(seed)
    P = 1 + B * nP
    Sk = nP * ps
    qq = quantize_fixed(2.0 * torch.randn(B, N, G, Sq, hd, generator=g))
    if fmt in ("int8", "fp8_v"):
        kp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        ks = torch.full((P, N), pool_scale(4))
        vs = torch.full((P, N), pool_scale(4))
        if fmt == "fp8_v":
            vp = to_fp8_e4m3(4.0 * torch.randn(P, ps, N, hd, generator=g))
            vs = torch.ones((P, N))
    else:
        dt = torch.bfloat16 if fmt == "bf16" else torch.float32
        kp = (4.0 * torch.randn(P, ps, N, hd, generator=g)).to(dt)
        vp = torch.randn(P, ps, N, hd, generator=g).to(dt)
        ks = vs = None
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, nP)
    page_live = torch.rand(B, nP, generator=g) < live
    keep = (torch.rand(B, N, G, nP, generator=g) < 0.6) \
        & page_live[:, None, None, :]
    fetched = keep.any(dim=2).any(dim=1)
    q0 = torch.randint(Sk // 2, Sk - Sq + 1, (B,), generator=g)
    q_pos = (q0[:, None] + torch.arange(Sq))[:, None, None, :]
    page_ids, logical, counts, keep_in, kv_len = _fetch_list(
        fetched, table, keep, q_pos)
    return dict(qq=qq, k_pool=kp, v_pool=vp, page_ids=page_ids,
                logical=logical, counts=counts, keep=keep_in, kv_len=kv_len,
                k_scale=ks, v_scale=vs, table=table, fetched=fetched,
                fmt=fmt)


def to_dev(case, dev):
    return {k: (v.to(dev) if hasattr(v, "to") else v)
            for k, v in case.items()}


def kernel_args(c):
    return ((c["qq"], c["k_pool"], c["v_pool"], c["page_ids"], c["logical"],
             c["counts"], c["keep"], c["kv_len"]),
            dict(k_scale=c["k_scale"], v_scale=c["v_scale"]))


def poison_pages(torch, c, pages, *, stage3_only):
    """Copies of the case's pools and scales with ``pages`` poisoned: V
    codes (int8 -128, fp8 NaN) and both scales of a quantized pool, with
    ``stage3_only`` (the pruned pages: K codes are the scout's stream and
    stay) or its K scale (a fetched page); NaN K and V of an unquantized
    pool."""
    from repro_torch.core.quant import POISON_CODE
    kp, vp = c["k_pool"].clone(), c["v_pool"].clone()
    ks = None if c["k_scale"] is None else c["k_scale"].clone()
    vs = None if c["v_scale"] is None else c["v_scale"].clone()
    if ks is None:
        kp[pages] = float("nan")
        vp[pages] = float("nan")
    elif stage3_only:
        if vp.dtype == torch.int8:
            vp[pages] = POISON_CODE
        else:
            vp[pages] = float("nan")
        ks[pages] = float("nan")
        vs[pages] = float("nan")
    elif vp.dtype == torch.int8:
        ks[pages] = float("nan")
    else:
        vp[pages] = float("nan")       # a NaN fp8 V code
    return kp, vp, ks, vs


def phase_kernels(torch):
    """The FUM decode kernel on every pool format (int8, fp32, fp8 V,
    bf16), split across blocks (``fum_splits``' S, and S = 3) and in one
    pass (S = 1), against its plain version on every case, with the two
    poison checks in each mode. Returns (worst max |err| per mode on the
    int8 and fp32 pools, and per format of the split mode; the qwen2
    int8 case)."""
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    cases = []
    for fmt in FUM_FORMATS:
        for Sq in (1, 3):
            cases.append((f"test B2N2G2Sq{Sq}hd8ps4 {fmt}",
                          dict(B=2, N=2, G=2, Sq=Sq, hd=8, ps=4, nP=8,
                               fmt=fmt, live=0.5, seed=Sq)))
        for Sq in (1, 3, 8):
            cases.append((f"qwen2 B8N2G6Sq{Sq}hd128ps128 {fmt}",
                          dict(B=8, N=2, G=6, Sq=Sq, hd=128, ps=128, nP=16,
                               fmt=fmt, live=0.5,
                               seed=7 if Sq == 1 else 8)))
        if fmt in ("fp8_v", "bf16"):
            cases.append((f"granite B8N8G4Sq1hd128ps128 {fmt}",
                          dict(B=8, N=8, G=4, Sq=1, hd=128, ps=128, nP=33,
                               fmt=fmt, live=0.3, seed=9)))
    worst, main_case = {"split": 0.0, "single": 0.0}, None
    worst.update({f: 0.0 for f in FUM_FORMATS})
    for label, kw in cases:
        c = to_dev(make_case(torch, **kw), "cuda")
        args, kws = kernel_args(c)
        ref = hdp_paged_fum_decode_ref(*args, **kws)
        tol = FUM_TOL[kw["fmt"]]
        for mode, splits in (("split", None), ("split", 3), ("single", 1)):
            tag = f"{label} [{mode}, S={splits or 'fum_splits'}]"
            fmt0 = hdp_paged_fum_decode.launches_by_format[kw["fmt"]]
            out, ran = on_path(tag, hdp_paged_fum_decode,
                               lambda: hdp_paged_fum_decode(
                                   *args, **kws, splits=splits), mode)
            torch.cuda.synchronize()
            check(hdp_paged_fum_decode.launches_by_format[kw["fmt"]]
                  == fmt0 + 1, f"{tag}: not launched as the {kw['fmt']} "
                  f"format ({hdp_paged_fum_decode.launches_by_format})")
            check(bool(torch.isfinite(out).all()), f"{tag}: non-finite output")
            err = (out - ref).abs().max().item()
            check(torch.allclose(out, ref, atol=tol, rtol=tol),
                  f"{tag}: kernel vs plain max |err| {err:.3e} (tol {tol})")
            # pruned pages are never read: poisoning them (V codes and
            # both scales, or NaN K/V) leaves the output bit-identical
            pruned = c["table"][~c["fetched"]].long()
            check(pruned.numel() > 0, f"{tag}: no pruned pages")
            kp, vp, ks, vs = poison_pages(torch, c, pruned, stage3_only=True)
            out_bad = hdp_paged_fum_decode(
                c["qq"], kp, vp, *args[3:], k_scale=ks, v_scale=vs,
                splits=splits)
            check(torch.equal(out, out_bad),
                  f"{tag}: poison on pruned pages changed the output")
            # ... and poison on one fetched, visible page must surface as
            # NaN (a NaN K scale, NaN fp8 V codes, or NaN K values)
            ps = kw["ps"]
            mk = c["page_ids"].shape[1]
            seen = (torch.arange(mk, device=c["counts"].device)[None]
                    < c["counts"][:, None]) \
                & (c["logical"] * ps < c["kv_len"][:, None])
            b, j = (int(x) for x in torch.nonzero(seen)[0])
            vis = int(c["page_ids"][b, j])
            kp, vp, ks, vs = poison_pages(torch, c, vis, stage3_only=False)
            out_nan = hdp_paged_fum_decode(
                c["qq"], kp, vp, *args[3:], k_scale=ks, v_scale=vs,
                splits=splits)
            torch.cuda.synchronize()
            check(bool(torch.isnan(out_nan[b]).any()),
                  f"{tag}: poison on a fetched page did not surface")
            log(f"[kernels] {tag}: max |kernel - plain| {err:.3e}, "
                f"pages kept {int(c['counts'].sum())}/{c['table'].numel()}, "
                "poison checks ok")
            if kw["fmt"] in ("int8", "fp32"):
                worst[mode] = max(worst[mode], err)
            if mode == "split":
                worst[kw["fmt"]] = max(worst[kw["fmt"]], err)
        if label.startswith("qwen2 B8N2G6Sq1") and kw["fmt"] == "int8":
            main_case = c
    return worst, main_case


# ----------------------------------------------- phase 3: the new kernels
def _randn(torch, shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).cuda()


def fixed_grid_split(torch, x):
    """(qq, iq) of x the way hdp_attention_tpu makes them ("max"
    calibration onto the Q4.12 grid): integer parts in [-16, 15]."""
    from repro_torch.core.quant import calib_scale, quantize_fixed
    xq = quantize_fixed(x.float() * calib_scale(x, 4, "max"))
    return xq, torch.trunc(xq)


def check_scout(torch, label, iq, ik, path=None, force=None, **kw):
    """Scout kernel vs plain: theta, keep and theta_head bit-equal (every
    sum is an exact integer rounded once, in both). ``path``: the path
    the call must take; ``force``: the wrapper's ``path`` argument."""
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import hdp_scout_plain
    (th, kp, hh), ran = on_path(label, hdp_scout, lambda: hdp_scout(
        iq, ik, path=force, **kw), path)
    pth, pkp, phh = hdp_scout_plain(iq, ik, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(th).all() and torch.isfinite(hh).all()),
          f"{label}: non-finite theta")
    err = (th - pth).abs().max().item()
    check(torch.equal(th, pth),
          f"{label} [{ran}]: theta kernel vs plain max |err| {err:.3e}")
    check(torch.equal(hh, phh),
          f"{label} [{ran}]: theta_head kernel vs plain differ")
    check(torch.equal(kp, pkp), f"{label} [{ran}]: keep differs in "
          f"{int((kp != pkp).sum())} blocks")
    log(f"[kernels] {label} [{ran}]: theta, keep and theta_head bit-equal "
        f"to the plain version")
    note_err("hdp_scout", ran, err)


def check_scout_bad_input(torch, path):
    """A value that is not an integer in [-128, 127] (0.5 in a q row of
    head 0, 200 in a k row of head 1) turns the theta of exactly the q
    tiles that read it to NaN, their keep to 0 and the heads' theta_head
    to NaN; every other tile equals the plain version."""
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import hdp_scout_plain
    bq = 128 if path == "tensor_core" else 32
    hd = 128 if path == "tensor_core" else 16
    shape = (1, 2, 4 * bq, hd)
    _, iq = fixed_grid_split(torch, _randn(torch, shape, 9))
    _, ik = fixed_grid_split(torch, _randn(torch, shape, 10))
    iq[0, 0, bq + 2, 5] = 0.5          # q tile 1 of head 0
    ik[0, 1, 2 * bq + 4, 7] = 200.0    # k block 2 of head 1: tiles 2, 3
    kw = dict(rho_b=0.5, block_q=bq, block_k=bq, causal=True)
    (th, kp, hh), _ = on_path(f"hdp_scout bad input [{path}]", hdp_scout,
                              lambda: hdp_scout(iq, ik, **kw), path)
    pth, pkp, _ = hdp_scout_plain(iq, ik, **kw)
    torch.cuda.synchronize()
    want = torch.tensor([[[False, True, False, False],
                          [False, False, True, True]]], device="cuda")
    nan_tile = torch.isnan(th).all(-1)
    check(torch.equal(nan_tile, want)
          and not bool(torch.isnan(th[~want]).any()),
          f"hdp_scout bad input [{path}]: NaN tiles {nan_tile.tolist()}, "
          f"expected {want.tolist()}")
    check(not bool(kp[want].any()) and torch.equal(kp[~want], pkp[~want])
          and torch.equal(th[~want], pth[~want]),
          f"hdp_scout bad input [{path}]: keep or clean tiles differ")
    check(bool(torch.isnan(hh).all()),
          f"hdp_scout bad input [{path}]: theta_head {hh.tolist()}")
    log(f"[kernels] hdp_scout bad input [{path}]: the 3 tiles that read it "
        "NaN with no kept block, both heads' theta_head NaN, the rest "
        "bit-equal")


def block_case(torch, *, B, H, S, hd, bq, bk, v_bf16, seed, gate=True,
               causal=True):
    """Block-kernel inputs as the pipeline makes them: fixed-grid qq/kq,
    the scout's keep on the card, its lists, one head gated."""
    from repro_torch.kernels.ref import hdp_scout_plain, keep_mask_to_indices
    qq, iq = fixed_grid_split(torch, _randn(torch, (B, H, S, hd), seed))
    kq, ik = fixed_grid_split(torch, _randn(torch, (B, H, S, hd), seed + 1))
    v = _randn(torch, (B, H, S, hd), seed + 2)
    if v_bf16:
        v = v.to(torch.bfloat16)
    theta, keep, _ = hdp_scout_plain(iq, ik, rho_b=0.5, block_q=bq,
                                     block_k=bk, causal=causal)
    idx, cnt = keep_mask_to_indices(keep, theta, keep.shape[-1])
    hk = torch.ones(B, H, dtype=torch.bool, device="cuda")
    if gate:
        hk[0, -1] = False
    return dict(q=qq, k=kq, v=v, kv_idx=idx, counts=cnt, head_kept=hk,
                causal=causal, block_q=bq, block_k=bk, score_scale=None,
                kv_len=None)


def decode_route_case(torch, seed):
    """The paged decode's block-kernel call at qwen2-1.5b's shape: one
    query row per (b, h) in an 8-row tile, 9 pages of 128 densified, a
    page keep mask, per-row kv_len, non-causal."""
    from repro_torch.core.quant import quantize_fixed
    from repro_torch.kernels.ref import keep_mask_to_indices
    B, H, hd, ps, nP = 8, 12, 128, 128, 9
    qq = quantize_fixed(_randn(torch, (B, H, 1, hd), seed, 2.0))
    kq = quantize_fixed(_randn(torch, (B, H, nP * ps, hd), seed + 1, 2.0))
    v = _randn(torch, (B, H, nP * ps, hd), seed + 2)
    g = torch.Generator().manual_seed(seed)
    keep = (torch.rand(B, H, 1, nP, generator=g) < 0.5).cuda()
    keep[..., 0] = True
    theta = torch.rand(B, H, 1, nP, generator=g).cuda()
    idx, cnt = keep_mask_to_indices(keep, theta, nP)
    lens = torch.randint(nP * ps // 2, nP * ps + 1, (B, 1), generator=g)
    hk = torch.rand(B, H, generator=g) < 0.8
    return dict(q=qq, k=kq, v=v, kv_idx=idx, counts=cnt,
                head_kept=hk.cuda(), causal=False, block_q=8, block_k=ps,
                score_scale=1.0, kv_len=lens.expand(B, H).int().cuda())


def block_args(c):
    return ((c["q"], c["k"], c["v"], c["kv_idx"], c["counts"],
             c["head_kept"]),
            {"approx": c.get("approx", True),
             **{k: c[k] for k in ("causal", "block_q", "block_k",
                                  "score_scale", "kv_len")}})


def on_path(label, fn, call, path):
    """Runs call() through the wrapper fn; checks that it launched one
    kernel, on ``path`` when one is given. Returns (result, path)."""
    before = dict(fn.launches_by_path)
    out = call()
    ran = [p for p, n in fn.launches_by_path.items() if n != before[p]]
    check(len(ran) == 1 and path in (None, ran[0]),
          f"{label}: launched on {ran}, expected {path or 'one path'}")
    return out, ran[0]


def check_block(torch, label, c, poison=True, path=None):
    """Block kernel vs plain; with ``poison`` NaN in every K/V block no
    q tile lists (and all of a gated head's) leaves the output
    bit-identical. Returns max |err|."""
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.ref import hdp_block_sparse_attention_plain
    args, kw = block_args(c)
    out, ran = on_path(label, hdp_block_sparse_attention,
                       lambda: hdp_block_sparse_attention(*args, **kw), path)
    ref = hdp_block_sparse_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = TOL_BF16 if c["v"].dtype == torch.bfloat16 else ATOL
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, atol=tol, rtol=tol),
          f"{label}: kernel vs plain max |err| {err:.3e}")
    n_unlisted = 0
    if poison:
        B, H, Sk, hd = c["k"].shape
        bk = c["block_k"]
        nk = -(-Sk // bk)
        mk = c["kv_idx"].shape[-1]
        listed = torch.zeros(B, H, nk + 1, dtype=torch.bool, device="cuda")
        live = (torch.arange(mk, device="cuda") < c["counts"][..., None]) \
            & c["head_kept"][..., None, None]
        blk = torch.where(live, c["kv_idx"].long(), nk)
        listed.scatter_(2, blk.flatten(2), True)
        col_listed = listed[..., :nk].repeat_interleave(bk, -1)[..., :Sk]
        n_unlisted = int((~listed[..., :nk]).sum())
        check(n_unlisted > 0, f"{label}: every block is listed")
        kp = torch.where(col_listed[..., None], c["k"], float("nan"))
        vp = torch.where(col_listed[..., None], c["v"],
                         torch.tensor(float("nan"), dtype=c["v"].dtype,
                                      device="cuda"))
        out_bad = hdp_block_sparse_attention(args[0], kp, vp, *args[3:], **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, out_bad),
              f"{label}: NaN in unlisted K/V blocks changed the output")
    log(f"[kernels] {label} [{ran}]: max |kernel - plain| {err:.3e}"
        + (f", {n_unlisted} unlisted blocks poisoned: output bit-identical"
           if poison else ""))
    note_err("hdp_block_sparse_attention", ran, err)
    return err


def check_flash(torch, label, q, k, v, causal, bq, bk, path=None):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    out, ran = on_path(label, flash_attention, lambda: flash_attention(
        q, k, v, causal=causal, block_q=bq, block_k=bk), path)
    ref = flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
    torch.cuda.synchronize()
    tol = TOL_BF16 if q.dtype == torch.bfloat16 else ATOL
    check(out.dtype == q.dtype and bool(torch.isfinite(out).all()),
          f"{label}: wrong dtype or non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
          f"{label}: kernel vs plain max |err| {err:.3e}")
    log(f"[kernels] {label} [{ran}]: max |kernel - plain| {err:.3e}")
    note_err("flash_attention", ran, err)
    return err


def note_err(name, path, err):
    entry = name if path == "tensor_core" else f"{name}[{path}]"
    ERRS[entry] = max(ERRS.get(entry, 0.0), err)


def phase_new_kernels(torch):
    """Scout, block and flash kernels vs their plain versions (their
    errors go to ERRS)."""
    small = [((1, 2, 128, 64), (64, 64)), ((1, 2, 18, 8), (2, 2)),
             ((1, 1, 100, 16), (32, 16))]
    # the scout: the reference tests' shapes (64x64 blocks at hd 64 take
    # the tensor-core path, 2x2 and 32x16 the dp4a path), the prefill's,
    # and the tensor-core path's edges: ragged S, 64-row blocks, hd 32 and
    # 96, int8 extremes (|s| up to 2^21, block sums up to 2^35)
    scout_cases = [(shape, blocks, rho, causal)
                   for shape, blocks in small for rho in (0.5, -0.5)
                   for causal in (True, False)]
    scout_cases += [((PREFILL_B, 12, PREFILL_S, 128), (128, 128), rho, True)
                    for rho in (0.5, -0.5)]
    scout_cases += [((1, 3, 300, 128), (128, 128), rho, causal)
                    for rho in (0.5, -0.5) for causal in (True, False)]
    scout_cases += [((1, 2, 384, 128), (64, 128), -0.5, True),
                    ((1, 2, 384, 128), (128, 64), 0.5, False),
                    ((1, 2, 250, 96), (64, 64), 0.5, True),
                    ((1, 2, 250, 32), (128, 128), -0.5, False)]
    from repro_torch.kernels.hdp_scout import scout_path
    for shape, (bq, bk), rho, causal in scout_cases:
        _, iq = fixed_grid_split(torch, _randn(torch, shape, 7))
        _, ik = fixed_grid_split(torch, _randn(torch, shape, 8))
        label = (f"hdp_scout {shape} blocks {bq}x{bk} rho {rho} "
                 f"{'causal' if causal else 'full'}")
        check_scout(torch, label, iq, ik, path=scout_path(shape[3], bq, bk),
                    rho_b=rho, block_q=bq, block_k=bk, causal=causal)
    # [B, H, S, hd] views of [B, S, H, hd] tensors, as the prefill passes
    _, iq = fixed_grid_split(torch, _randn(torch, (1, 300, 3, 128), 7))
    _, ik = fixed_grid_split(torch, _randn(torch, (1, 300, 3, 128), 8))
    check_scout(torch, "hdp_scout (1, 3, 300, 128) strided views blocks "
                "128x128", iq.transpose(1, 2), ik.transpose(1, 2),
                path="tensor_core", rho_b=0.5, block_q=128, block_k=128,
                causal=True)
    g = torch.Generator().manual_seed(3)
    for shape in ((1, 2, 384, 128), (1, 1, 300, 128)):
        iq, ik = (torch.where(torch.rand(shape, generator=g) < 0.5, -128.0,
                              127.0).cuda() for _ in range(2))
        ik[..., ::3, :] = -128.0
        for causal in (True, False):
            check_scout(torch, f"hdp_scout {shape} int8 extremes "
                        f"{'causal' if causal else 'full'}", iq, ik,
                        path="tensor_core", rho_b=0.5, block_q=128,
                        block_k=128, causal=causal)
    for path in ("tensor_core", "dp4a"):
        check_scout_bad_input(torch, path)
    for (B, H, S, hd), (bq, bk) in small + [((PREFILL_B, 12, PREFILL_S,
                                              128), (128, 128))]:
        for v_bf16 in (False, True):
            c = block_case(torch, B=B, H=H, S=S, hd=hd, bq=bq, bk=bk,
                           v_bf16=v_bf16, seed=11, gate=H > 1)
            label = (f"hdp_block_sparse_attention {(B, H, S, hd)} blocks "
                     f"{bq}x{bk} v {'bf16' if v_bf16 else 'fp32'}")
            check_block(torch, label, c)
    check_block(torch, "hdp_block_sparse_attention decode route "
                "[8,12,1,128] x [8,12,1152,128] blocks 8x128",
                decode_route_case(torch, 21), path="tile")
    for (B, H, S, hd), (bq, bk) in small + [((PREFILL_B, 12, PREFILL_S,
                                              128), (128, 128))]:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                if S == PREFILL_S and (dt == torch.float32 or not causal):
                    continue
                q, k, v = (_randn(torch, (B, H, S, hd), s, 2.0).to(dt)
                           for s in (1, 2, 3))
                label = (f"flash_attention {(B, H, S, hd)} blocks {bq}x{bk} "
                         f"{str(dt)[6:]} {'causal' if causal else 'full'}")
                check_flash(torch, label, q, k, v, causal, bq, bk)
    # the tensor-core paths: S not a multiple of the tile, hd 64,
    # non-causal, approx off, kv_len and score_scale, a gated head, and
    # the first row's last q tile listing no block
    g = torch.Generator().manual_seed(17)
    for (B, H, S, hd), (bq, bk), causal, approx in (
            ((1, 3, 4000, 128), (128, 128), True, True),
            ((1, 3, 4000, 128), (128, 128), False, False),
            ((1, 2, 1000, 64), (64, 64), True, True),
            ((1, 2, 1000, 64), (64, 128), False, True),
            ((1, 2, 1000, 128), (128, 64), True, True)):
        c = block_case(torch, B=B, H=H, S=S, hd=hd, bq=bq, bk=bk,
                       v_bf16=True, seed=13, causal=causal)
        c["approx"] = approx
        c["counts"][0, 0, -1] = 0
        extra = ""
        if not causal:
            c["kv_len"] = torch.randint(S // 2, S + 1, (B, H),
                                        generator=g).int().cuda()
            c["score_scale"] = torch.tensor([0.37], device="cuda")
            extra = " kv_len score_scale"
        label = (f"hdp_block_sparse_attention {(B, H, S, hd)} blocks "
                 f"{bq}x{bk} v bf16 {'causal' if causal else 'full'} approx "
                 f"{approx}{extra}, head gated, a q tile listing none")
        check_block(torch, label, c, path="tensor_core")
    for (B, H, S, hd) in ((1, 3, 4000, 128), (1, 2, 1000, 64)):
        for causal in (True, False):
            q, k, v = (_randn(torch, (B, H, S, hd), s, 2.0).to(torch.bfloat16)
                       for s in (4, 5, 6))
            label = (f"flash_attention {(B, H, S, hd)} bfloat16 "
                     f"{'causal' if causal else 'full'}")
            check_flash(torch, label, q, k, v, causal, 128, 128,
                        path="tensor_core")


# ------------------------------------------------ phase 4: aligned prefill
class Recorder:
    """Wraps a kernel wrapper; keeps the inputs of the call with the
    largest ``key`` (the last call when key is None; a key of None skips
    the call). With ``clone`` it keeps copies, for a path that later
    rewrites what the call read (a speculative round rolls back and
    poisons pool pages)."""

    def __init__(self, fn, key=None, clone=False):
        self.fn, self.key, self.clone = fn, key, clone
        self.best, self.score = None, None

    def __call__(self, *args, **kw):
        score = 0 if self.key is None else self.key(args)
        if score is not None and (self.score is None or score >= self.score):
            if self.clone:
                args = tuple(a.clone() for a in args)
                kw = {k: (v.clone() if hasattr(v, "clone") else v)
                      for k, v in kw.items()}
            self.best, self.score = (args, kw), score
        return self.fn(*args, **kw)


def listed_pages(args):
    """The pages a FUM-kernel call lists (its counts summed)."""
    return int(args[5].sum())


def listed_pages_verify(args):
    """``listed_pages`` of a verify call (Sq > 1); None for a step."""
    return listed_pages(args) if args[0].shape[3] > 1 else None


def live_blocks(args):
    """The blocks a block-kernel call loads: the listed blocks of kept
    heads (args as the wrapper takes them)."""
    counts, head_kept = args[4], args[5]
    return int((counts * (head_kept[..., None] > 0)).sum())


def _resolved(cfg, **kw):
    from repro_torch.attention import resolve_backend
    from repro_torch.models.attention import build_attn_call
    return resolve_backend(build_attn_call(cfg, **kw)).name


def phase_aligned_prefill(torch, cfg, params):
    """qwen2-1.5b at full width, B 2, S 4096: HDP on through the scout and
    block kernels, HDP off through flash, each launched once per layer;
    kernel vs plain at the path's own inputs; the reduced config's
    aligned-prefill logits on the card vs the CPU."""
    import numpy as np
    import repro_torch.kernels.ops as ops
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.models import registry
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()
    out = {}
    rec = {"scout": Recorder(hdp_scout),
           "block": Recorder(hdp_block_sparse_attention,
                             key=live_blocks),
           "flash": Recorder(flash_attention)}
    ops.hdp_scout, ops.hdp_block_sparse_attention, ops.flash_attention = \
        rec["scout"], rec["block"], rec["flash"]
    try:
        for hdp_on in (True, False):
            c = cfg.replace(hdp=cfg.hdp.replace(enabled=hdp_on))
            backend = _resolved(c, mode="prefill", self_aligned=True)
            check(backend == ("pallas_hdp_block" if hdp_on else
                              "pallas_flash"),
                  f"aligned prefill (HDP {hdp_on}) resolved to {backend}")
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            logits, cache, st = registry.apply_prefill(
                c, params, {"tokens": toks}, None, collect_stats=hdp_on)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {"hdp_scout": hdp_scout.launches,
                 "hdp_block_sparse_attention":
                     hdp_block_sparse_attention.launches,
                 "flash_attention": flash_attention.launches}
            check(cache is None and tuple(logits.shape) ==
                  (PREFILL_B, 1, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"aligned prefill (HDP {hdp_on}): bad logits")
            want = ({"hdp_scout": N_LAYERS_QWEN,
                     "hdp_block_sparse_attention": N_LAYERS_QWEN,
                     "flash_attention": 0} if hdp_on else
                    {"hdp_scout": 0, "hdp_block_sparse_attention": 0,
                     "flash_attention": N_LAYERS_QWEN})
            check(n == want, f"aligned prefill (HDP {hdp_on}) launches {n}, "
                  f"expected {want}")
            tc = {k: f.launches_by_path["tensor_core"] for k, f in (
                ("hdp_scout", hdp_scout),
                ("hdp_block_sparse_attention", hdp_block_sparse_attention),
                ("flash_attention", flash_attention))}
            check(all(tc[k] == want[k] for k in tc),
                  f"aligned prefill (HDP {hdp_on}): tensor-core launches {tc},"
                  f" expected every launch of {want}")
            msg = ""
            if hdp_on:
                msg = (f", block/head sparsity "
                       f"{st['block_sparsity'].mean().item():.4f}/"
                       f"{st['head_sparsity'].mean().item():.4f}")
            log(f"[prefill] qwen2-1.5b B{PREFILL_B} S{PREFILL_S} HDP "
                f"{'on' if hdp_on else 'off'} -> {backend}: {wall:.3f} s, "
                f"launches {n}, on the tensor-core path {tc}{msg}")
            out.update({k: v for k, v in n.items() if v})
    finally:
        ops.hdp_scout = hdp_scout
        ops.hdp_block_sparse_attention = hdp_block_sparse_attention
        ops.flash_attention = flash_attention
    calls = {k: r.best for k, r in rec.items()}
    # the kernels against their plain versions at the path's own inputs
    (iq, ik), kw = calls["scout"]
    check_scout(torch, "hdp_scout at the path's last call", iq, ik,
                path="tensor_core", **kw)
    check_scout(torch, "hdp_scout, the dp4a kernel, at the path's last call",
                iq, ik, path="dp4a", force="dp4a", **kw)
    args, kw = calls["block"]
    c = dict(zip(("q", "k", "v", "kv_idx", "counts", "head_kept"), args),
             **{"kv_len": None, "score_scale": None, **kw})
    check_block(
        torch, f"hdp_block_sparse_attention at the path's call that kept "
        f"the most blocks ({live_blocks(args)})", c, path="tensor_core")
    (q, k, v), kw = calls["flash"]
    check_flash(
        torch, "flash_attention at the path's last call", q, k, v,
        kw["causal"], kw["block_q"], kw["block_k"], path="tensor_core")

    # the reduced config's aligned prefill: card (kernels) vs CPU (plain),
    # in fp32 (atol 1e-4) and in bf16, where the block kernel's fp32
    # output meets bf16 wo in fp32 and is rounded to bf16 (2e-2); hd 16
    # and 2x2 blocks take the tile kernels and the dp4a scout. The fp32
    # runs are the paths of the tile flash kernel (HDP off) and the dp4a
    # scout (HDP on): their launches are counted.
    stoks = torch.from_numpy(np.random.default_rng(6).integers(
        1, reduced(cfg).vocab_size, (2, 18)))
    for dtype, tol in (("float32", (ATOL, 0.0)),
                       ("bfloat16", (TOL_BF16, TOL_BF16))):
        small = reduced(cfg).replace(dtype=dtype)
        sp = registry.init_params(small, 1, "cuda")
        sp_cpu = _tree_to(sp, "cpu")
        for hdp_on in (True, False):
            c = small.replace(hdp=small.hdp.replace(enabled=hdp_on))
            zero_launches()
            ops.hdp_scout = small_scout = Recorder(hdp_scout)
            try:
                lg, _, sg = registry.apply_prefill(
                    c, sp, {"tokens": stoks.cuda()}, None,
                    collect_stats=hdp_on)
            finally:
                ops.hdp_scout = hdp_scout
            if dtype == "float32" and hdp_on:
                dp4a = hdp_scout.launches_by_path["dp4a"]
                check(dp4a == small.n_layers == hdp_scout.launches,
                      f"reduced fp32 aligned prefill: scout launches "
                      f"{hdp_scout.launches_by_path}, expected "
                      f"{small.n_layers} on the dp4a path")
                (iq, ik), kw = small_scout.best
                check_scout(torch, "hdp_scout at the reduced prefill's last "
                            "call", iq, ik, path="dp4a", **kw)
            if dtype == "float32" and not hdp_on:
                tile_flash = flash_attention.launches_by_path["tile"]
                check(tile_flash == small.n_layers == flash_attention.launches,
                      f"reduced fp32 aligned prefill: flash launches "
                      f"{flash_attention.launches_by_path}, expected "
                      f"{small.n_layers} on the tile path")
            lc, _, sc = registry.apply_prefill(
                c, sp_cpu, {"tokens": stoks}, None, collect_stats=hdp_on)
            err = (lg.cpu() - lc).abs().max().item()
            backend = _resolved(c, mode="prefill", self_aligned=True)
            msg = ""
            if hdp_on:
                msg = (", block sparsity card/CPU "
                       f"{sg['block_sparsity'].mean().item():.4f}/"
                       f"{sc['block_sparsity'].mean().item():.4f}")
            check(lg.dtype == torch.float32 and torch.allclose(
                lg.cpu(), lc, atol=tol[0], rtol=tol[1]),
                f"reduced {dtype} aligned prefill (HDP {hdp_on}): card vs "
                f"CPU logits max |err| {err:.3e}{msg}")
            log(f"[prefill] reduced qwen2-1.5b {dtype} aligned prefill HDP "
                f"{'on' if hdp_on else 'off'} ({backend}): card vs CPU "
                f"logits max |err| {err:.3e} (max |logit| "
                f"{lc.abs().max().item():.3e}){msg}")
    out["flash_attention[tile]"] = tile_flash
    out["hdp_scout[dp4a]"] = dp4a
    return out, calls


def zero_launches():
    """Sets every kernel wrapper's launch counts, and the kernels' own
    counts of their runs on the card, to 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.hdp_scout import hdp_scout
    for fn in (hdp_paged_fum_decode, hdp_scout, hdp_block_sparse_attention,
               flash_attention):
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    hdp_paged_fum_decode.launches_by_format = dict.fromkeys(
        hdp_paged_fum_decode.launches_by_format, 0)
    hdp_paged_fum_decode.runs.zero()
    hdp_block_sparse_attention.runs.zero()


# ------------------------------------------------------------ phase 5
SERVE_KW = dict(max_batch=8, max_len=1056, prefill_buckets=(256, 512, 1024),
                collect_stats=True)
LONG_PROMPTS, LONG_MAX_LEN = (2500, 4000), 4128


def serve(torch, eng, prompts, max_new):
    """Serve ``prompts`` through ``eng`` with every launch count zeroed
    first. Returns (tokens by uid, summary, wall s, FUM and block wrapper
    launches by path, and the runs of the FUM and the block tile kernel
    on the card over the whole serve, by their own counts: the only
    count of what a graph's replays ran)."""
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.serving import Request
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, max_new_tokens=max_new))
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = {"fum": hdp_paged_fum_decode.runs.read(),
            "block": hdp_block_sparse_attention.runs.read()}
    s = eng.summary()
    check(len(res) == len(prompts) and all(
        r.complete and r.status == "ok" and len(r.tokens) == max_new
        and all(0 <= t < eng.cfg.vocab_size for t in r.tokens)
        for r in res.values()),
        f"not every request completed with {max_new} tokens: "
        f"{[(u, r.status, r.error, len(r.tokens)) for u, r in res.items()]}")
    launches = {"fum": dict(hdp_paged_fum_decode.launches_by_path),
                "block": dict(hdp_block_sparse_attention.launches_by_path),
                "fum_format": dict(hdp_paged_fum_decode.launches_by_format)}
    return {u: r.tokens for u, r in res.items()}, s, wall, launches, runs


def check_decode_launches(s, launches, kernel, label, runs,
                          n_layers=N_LAYERS_QWEN):
    """The engine counts ``n_layers`` launches of ``kernel`` ("fum" or
    "block") per decode step and none of the other. Eagerly the wrapper
    counts the same. Graphed, the wrapper is called twice per layer and capture:
    the eager warm-up step and the capture, which records the kernel
    and runs nothing; the replays never call it. The kernel's own count
    of its runs on the card (``runs``) must be the engine's plus the
    warm-up step's: the launches the replays really ran."""
    other = "block" if kernel == "fum" else "fum"
    steps, caps = s["decode_steps"], s["graph_captures"]
    n = s[f"{kernel}_kernel_launches"]
    wrapper = sum(launches[kernel].values())
    want_wrapper = 2 * n_layers * caps if caps else n
    check(n == n_layers * steps and n > 0
          and s[f"{other}_kernel_launches"] == 0
          and not any(launches[other].values()),
          f"{label}: {kernel} kernel launched {n} times by the decode steps "
          f"(other kernel {s[f'{other}_kernel_launches']}), expected "
          f"{n_layers} x {steps} decode steps")
    check(wrapper == want_wrapper,
          f"{label}: the {kernel} wrapper counted {wrapper} launches, "
          f"expected {want_wrapper}")
    want = n + n_layers * caps
    check(runs[kernel] == want and runs[other] == 0,
          f"{label}: the kernels counted {runs} runs on the card, expected "
          f"{want} of {kernel} ({n_layers} layers x {steps} decode steps + "
          f"{caps} warm-up step(s)) and none of {other}")
    log(f"[serve] {label}: {runs[kernel]} runs of the {kernel} kernel on "
        f"the card = {n_layers} layers x ({steps} decode steps + {caps} "
        f"warm-up step(s)), the engine counted {n} for the steps, the "
        f"wrapper {launches[kernel]}")


def log_served(label, s, wall):
    log(f"[serve] {label}: wall {wall:.2f} s, prefill_s "
        f"{s['prefill_s']:.3f}, decode_tok_s {s['decode_tok_s']:.1f} "
        f"(without the graph's capture {s['decode_tok_s_steady']:.1f}), "
        f"decode_steps {s['decode_steps']}, decode_horizon "
        f"{s['decode_horizon']}, cuda_graph {s['cuda_graph']}, FUM/block "
        f"launches {s['fum_kernel_launches']}/{s['block_kernel_launches']}, "
        f"block/head/page sparsity {s['block_sparsity']:.4f}/"
        f"{s['head_sparsity']:.4f}/{s['page_sparsity']:.4f}")
    if s["graph_captures"]:
        log(f"[serve] {label}: decode graph captured "
            f"{s['graph_captures']}x in {s['graph_capture_s']:.3f} s "
            "(with its eager warm-up step), memory it holds: allocated "
            f"{s['graph_allocated_bytes'] / 2**20:.2f} MiB, reserved "
            f"{s['graph_reserved_bytes'] / 2**20:.2f} MiB")


def phase_serving(torch, cfg, params):
    """The serving traffic eagerly (the FUM kernel recorded and held
    against its plain version at the path's call that listed the most
    pages), then on the decode graph at horizons 1 and 4 (tokens equal
    the eager run's, launches 28 per step, cross-checked by the kernel's
    count on the card); the block decode route eagerly and graphed; chunked
    prefill of 2,500 and 4,000 tokens; the reduced config graphed on the
    card against the CPU, with a chunked prompt."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.configs import reduced
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    from repro_torch.serving import Engine, Request
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}")
    out = {}

    # eagerly, keeping the inputs of the FUM call of the path that
    # listed the most pages, to hold the kernel against its plain version
    # there; a graph's replays would overwrite the recorded buffers
    rec = Recorder(hdp_paged_fum_decode, key=listed_pages, clone=True)
    eng = Engine(cfg, params, device="cuda", cuda_graph=False, **SERVE_KW)
    torch.cuda.reset_peak_memory_stats()
    attention.hdp_paged_fum_decode = rec
    try:
        eager_tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
    finally:
        attention.hdp_paged_fum_decode = hdp_paged_fum_decode
    del eng
    eager_tok_s = s["decode_tok_s"]
    log_served("eager, horizon 1", s, wall)
    log(f"[serve] summary {json.dumps(s, default=str)}")
    log(f"[serve] cache_bytes_per_token {s['cache_bytes_per_token']}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(s["attn_decode_stage3"].startswith("cuda"),
          f"decode stage 3 resolved to {s['attn_decode_stage3']}")
    check_decode_launches(s, launches, "fum", "eager", runs)
    check(launches["fum"]["split"] == s["fum_kernel_launches"],
          f"FUM launches by mode {launches['fum']}: expected every launch "
          "split across blocks")
    log(f"[serve] eager: FUM kernel launches {s['fum_kernel_launches']} = "
        f"{N_LAYERS_QWEN} layers x {s['decode_steps']} decode steps, by "
        f"mode {launches['fum']}")
    check(rec.score > 0, "no FUM call of the path listed a page")
    (args, kw), rec = rec.best, None
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    path_err = {}
    for mode, splits in (("split", None), ("single", 1)):
        got = hdp_paged_fum_decode(*args, **kw, splits=splits)
        torch.cuda.synchronize()
        path_err[mode] = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, atol=ATOL, rtol=RTOL),
            f"kernel [{mode}] vs plain at the path's own inputs: max |err| "
            f"{path_err[mode]:.3e}")
    log(f"[serve] kernel vs plain at the path's call that listed the most "
        f"pages (qq {tuple(args[0].shape)}, page lists "
        f"{tuple(args[3].shape)}, {listed_pages(args)} pages listed): max "
        f"|err| {path_err}")
    del args, kw, ref

    # the main path: the decode step as one CUDA graph, horizons 1 and 4
    for horizon in (1, 4):
        eng = Engine(cfg, params, device="cuda", decode_horizon=horizon,
                     **SERVE_KW)
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng
        label = f"graphed, horizon {horizon}"
        log_served(label, s, wall)
        check(tok == eager_tok, f"{label}: tokens differ from the eager "
              f"run's: {tok} vs {eager_tok}")
        if horizon == 1:
            out["h1_tokens"] = tok
        check(s["graph_captures"] == 1, f"{label}: {s['graph_captures']} "
              "graph captures, expected 1")
        check_decode_launches(s, launches, "fum", label, runs)
        check(launches["fum"]["split"] == sum(launches["fum"].values()),
              f"{label}: FUM launches by mode {launches['fum']}: expected "
              "every launch split across blocks")
        log(f"[serve] {label}: tokens == the eager run's; FUM kernel "
            f"launches {s['fum_kernel_launches']} = {N_LAYERS_QWEN} layers "
            f"x {s['decode_steps']} decode steps")
        check(s["decode_tok_s"] > eager_tok_s,
              f"{label}: decode_tok_s {s['decode_tok_s']:.1f} is not above "
              f"the eager run's {eager_tok_s:.1f}")
        if horizon == 1:
            # every wrapper call was split, so the single mode ran nothing
            out["fum"] = {"split": runs["fum"],
                          "single": launches["fum"]["single"]}

    # the paged decode through the block-sparse kernel on a densified
    # gather: once per layer per decode step, FUM kernel not at all;
    # eagerly (recorded), then graphed at horizon 4
    block_tok = {}
    for graphed in (False, True):
        beng = Engine(cfg, params, device="cuda", attn="pallas_hdp_block",
                      cuda_graph=graphed, decode_horizon=4 if graphed else 1,
                      **SERVE_KW)
        check(beng.resolved_backend("decode") == "pallas_hdp_block",
              f"attn=pallas_hdp_block decode resolved to "
              f"{beng.resolved_backend('decode')}")
        if not graphed:
            rec = Recorder(hdp_block_sparse_attention, key=live_blocks)
            attention.hdp_block_sparse_attention = rec
        try:
            block_tok[graphed], bs, wall, launches, runs = serve(
                torch, beng, prompts, 16)
        finally:
            attention.hdp_block_sparse_attention = hdp_block_sparse_attention
        del beng
        label = ("attn=pallas_hdp_block, "
                 + ("graphed, horizon 4" if graphed else "eager, horizon 1"))
        log_served(label, bs, wall)
        check(bs["attn_decode_stage3"] == "cuda:hdp_block_sparse_attention",
              f"decode stage 3 resolved to {bs['attn_decode_stage3']}")
        check_decode_launches(bs, launches, "block", label, runs)
        check(launches["block"]["tile"] == sum(launches["block"].values()),
              f"{label}: block launches {launches['block']}, expected all "
              "on the tile path")
        log(f"[serve] {label}: block kernel launches (tile path) "
            f"{bs['block_kernel_launches']} = {N_LAYERS_QWEN} layers x "
            f"{bs['decode_steps']} decode steps")
        if graphed:
            out["block_tile"] = runs["block"]
    check(block_tok[True] == block_tok[False],
          "attn=pallas_hdp_block: graphed tokens differ from the eager run's")
    log("[serve] attn=pallas_hdp_block: graphed horizon-4 tokens == eager")
    check(rec.score > 0, "no block-kernel call of the decode route loaded "
          "a block")
    args, kw = rec.best
    c = dict(zip(("q", "k", "v", "kv_idx", "counts", "head_kept"), args),
             **kw)
    check_block(
        torch, f"hdp_block_sparse_attention at the decode route's call that "
        f"kept the most blocks ({rec.score}; q {tuple(args[0].shape)}, "
        f"k/v {tuple(args[1].shape)})", c, path="tile")

    # chunked prefill at full width: 1,024-token chunks plus the tail
    long_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                    for n in LONG_PROMPTS]
    leng = Engine(cfg, params, device="cuda", max_batch=2,
                  max_len=LONG_MAX_LEN, prefill_buckets=(256, 512, 1024),
                  decode_horizon=4, collect_stats=True)
    chunks = []
    chunk_step = leng._chunk_step

    def counting(prompt, cache, off):
        nxt = chunk_step(prompt, cache, off)
        chunks.append((len(prompt), off, nxt - off))
        return nxt

    leng._chunk_step = counting
    _, ls, wall, launches, runs = serve(torch, leng, long_prompts, 32)
    del leng._chunk_step   # the closure holds the engine: free it with del
    del leng
    want = []
    for n in LONG_PROMPTS:
        off = 0
        while off < n:
            clen = 1024 if n - off >= 1024 else next(
                b for b in (256, 512, 1024) if b >= n - off)
            want.append((n, off, clen))
            off += clen
    log_served(f"chunked prefill of {list(LONG_PROMPTS)} tokens", ls, wall)
    check(chunks == want and ls["prefill_calls"] == 2
          and ls["prefill_tokens"] == sum(c for *_, c in want),
          f"chunked prefill ran chunks {chunks} ({ls['prefill_calls']} "
          f"prefills, {ls['prefill_tokens']} tokens), expected {want}")
    check_decode_launches(ls, launches, "fum", "chunked prefill", runs)
    log(f"[serve] chunked prefill: {len(chunks)} chunk calls "
        f"(prompt, offset, length) {chunks}, prefill_s "
        f"{ls['prefill_s']:.3f}, both requests complete")

    # agreement with a reference on a small input: the reduced config
    # graphed at horizon 4 on the card (kernels) and on the CPU (plain
    # versions), same weights, one prompt chunked (40 > bucket 32)
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    gpu = Engine(small, device="cuda", seed=1, decode_horizon=4, **kw)
    cpu_params = {k: _tree_to(v, "cpu") for k, v in gpu.params.items()}
    cpu = Engine(small, cpu_params, device="cpu", **kw)
    prng = np.random.default_rng(3)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(4)] + [prng.integers(1, 250, size=40).tolist()]
    toks = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
    check(gpu.metrics["graph_captures"] == 1 and
          gpu.metrics["prefill_calls"] == cpu.metrics["prefill_calls"],
          f"reduced qwen2: card engine {gpu.metrics}")
    check(toks[0] == toks[1], f"reduced qwen2 tokens differ card vs CPU: "
          f"{toks[0]} vs {toks[1]}")
    log("[serve] reduced qwen2-1.5b (one prompt of 40 tokens chunked): "
        "card tokens (graphed, horizon 4) == CPU plain-path tokens")
    return out, path_err, rec.best


# ------------------------- phase 5d: prefix cache and speculative decode
PREFIX_KW = dict(max_batch=8, max_len=2048, prefill_buckets=(256, 512, 1024),
                 decode_horizon=4)
SHARED_LEN = 1024
#: the draft lengths of the graphed speculative serves
DRAFT_LENS = (4, 8)
#: depth of the fp32-pool speculative run (qwen2-1.5b cut to it)
FP32_POOL_LAYERS = 8


def prefix_traffic(vocab):
    """Seed 0: a 1,024-token shared prompt; the warm-up request (the
    prompt and a 64-token tail), then 6 requests of the prompt and
    distinct tails of 32-480 tokens (chunked: past the largest bucket),
    and 2 that are exactly its first 512 and 1,024 tokens (full hits)."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, size=SHARED_LEN).tolist()
    warm = shared + rng.integers(1, vocab, size=64).tolist()
    tails = [shared + rng.integers(1, vocab, size=int(n)).tolist()
             for n in rng.integers(32, 481, size=6)]
    return warm, tails + [shared[:512], shared[:SHARED_LEN]]


def serve_prefix(torch, cfg, params, prefix_cache):
    """The prefix traffic through one engine: the warm-up request alone,
    then the 8 others. Returns (tokens of all 9, summary, engine)."""
    from repro_torch.serving import Engine, Request
    eng = Engine(cfg, params, device="cuda", prefix_cache=prefix_cache,
                 **PREFIX_KW)
    warm, rest = prefix_traffic(cfg.vocab_size)
    eng.submit(Request(0, warm, max_new_tokens=32))
    eng.run()
    for uid, p in enumerate(rest, start=1):
        eng.submit(Request(uid, p, max_new_tokens=32))
    res = eng.run()
    torch.cuda.synchronize()
    check(len(res) == 9 and all(r.complete and len(r.tokens) == 32
                                for r in res.values()),
          f"prefix traffic: not every request completed: "
          f"{[(u, r.status, len(r.tokens)) for u, r in res.items()]}")
    return {u: r.tokens for u, r in res.items()}, eng.summary(), eng


def single_step_lists(torch, args, j):
    """The inputs of the single decode step at verify row j: row j's
    query, its keep flags, its extent, and the page list restricted to
    the pages some head keeps for row j (ascending, scratch-padded)."""
    qq, kp, vp, page_ids, logical, counts, keep, kv_len = args
    B, mk = page_ids.shape
    listed = torch.arange(mk, device=page_ids.device)[None] < counts[:, None]
    mine = listed & (keep[..., j] > 0).flatten(2).any(-1)          # [B,mk]
    order = torch.sort(torch.where(mine, torch.arange(
        mk, device=mine.device)[None], mk), dim=1).values
    cnt = mine.sum(1).to(torch.int32)
    valid = torch.arange(mk, device=mine.device)[None] < cnt[:, None]
    idx = torch.clamp(order, max=mk - 1).long()
    pick = lambda t: torch.where(valid, torch.gather(t, 1, idx), 0).to(
        torch.int32).contiguous()
    keep_j = torch.gather(keep[..., j:j + 1], 1, idx[:, :, None, None, None]
                          .expand(-1, -1, *keep.shape[2:4], 1))
    keep_j = torch.where(valid[:, :, None, None, None], keep_j, 0)
    return (qq[:, :, :, j:j + 1].contiguous(), kp, vp, pick(page_ids),
            pick(logical), cnt.contiguous(), keep_j.contiguous(),
            (kv_len + j).to(torch.int32).contiguous())


def check_verify_call(torch, label, rec):
    """The FUM kernel at the path's recorded verify call against its plain
    version (phase 3's tolerances), and each of its rows bit-equal to
    the single step at that row's position. Returns max |err|."""
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    check(rec.best is not None and rec.score > 0,
          f"{label}: no verify call of the path listed a page")
    args, kw = rec.best
    Sq = args[0].shape[3]
    tol = ATOL if args[2].dtype == torch.int8 else TOL_BF16
    got = hdp_paged_fum_decode(*args, **kw)
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got, ref, atol=tol, rtol=tol),
        f"{label}: kernel vs plain at the verify call: max |err| {err:.3e}")
    worst = 0.0
    for j in range(Sq):
        one = hdp_paged_fum_decode(*single_step_lists(torch, args, j), **kw)
        worst = max(worst, (got[:, :, :, j] - one[:, :, :, 0]).abs().max()
                    .item())
    check(worst == 0.0, f"{label}: verify rows differ from the single "
          f"steps at their positions by up to {worst:.3e}")
    log(f"[spec] {label}: FUM kernel vs plain at the verify call that "
        f"listed the most pages (qq {tuple(args[0].shape)}, {rec.score} "
        f"pages listed): max |err| {err:.3e}; each of its {Sq} rows "
        "bit-equal to the single step at its position")
    return err


def first_divergence(a, b):
    """Per request: (first index where the token lists differ, the two
    tokens) for the requests whose lists differ."""
    out = {}
    for u in a:
        if a[u] != b[u]:
            i = next((i for i, (x, y) in enumerate(zip(a[u], b[u]))
                      if x != y), min(len(a[u]), len(b[u])))
            out[u] = (i, a[u][i:i + 1], b[u][i:i + 1])
    return out


def phase_spec_prefix(torch, cfg, params, h1_tokens):
    """qwen2-1.5b at full width: the prefix traffic hot and cold (head
    pruning off, the reference's identity setting) with equal tokens, 8
    hits, 2 COWs and a drained pool, then hot on the stock config;
    speculative decode, graphed, at draft lengths 4 and 8 on phase 5's
    traffic with the graphed horizon-1 engine's tokens (``h1_tokens``),
    the FUM kernel 28 times a verify and never in a draft step, held
    against its plain version at the path's verify call; the fp32
    ("model dtype") pool with its fraction copy, cut to 8 layers; the
    reduced config with both features, card vs CPU. Returns
    {draft_len: (launches at that width, max |err|)}."""
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.attention import AttnSpec
    from repro_torch.configs import reduced
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.serving import Engine, Request

    # ---- prefix cache: hot equals cold with the head gate off
    nogate = cfg.replace(hdp=cfg.hdp.replace(head_pruning=False))
    cold_tok, cs, _ = serve_prefix(torch, nogate, params, False)
    hot_tok, hs, heng = serve_prefix(torch, nogate, params, True)
    bad = first_divergence(hot_tok, cold_tok)
    check(not bad, f"prefix hit tokens differ from cold (uid: first index, "
          f"hot, cold): {bad}")
    check(hs["prefix_hits"] == 8 and hs["cow_copies"] >= 2,
          f"prefix cache: {hs['prefix_hits']} hits and {hs['cow_copies']} "
          "COW copies, expected 8 and >= 2")
    heng.prefix.clear()
    heng.pages.allocator.assert_drained()
    del heng
    log(f"[prefix] head gate off: 9 requests' tokens hot == cold; hits "
        f"{hs['prefix_hits']}, hit tokens {hs['prefix_hit_tokens']}, COW "
        f"copies {hs['cow_copies']}, pages cached {hs['pages_cached']}, "
        f"pool drained after clear(); prefill_s hot {hs['prefill_s']:.3f} "
        f"vs cold {cs['prefill_s']:.3f} (prefill tokens "
        f"{hs['prefill_tokens']} vs {cs['prefill_tokens']}, calls "
        f"{hs['prefill_calls']} vs {cs['prefill_calls']})")
    _, ss, seng = serve_prefix(torch, cfg, params, True)
    del seng
    log(f"[prefix] stock config (head pruning on): hits "
        f"{ss['prefix_hits']}, prefill_s {ss['prefill_s']:.3f}, decode "
        f"tok/s {ss['decode_tok_s']:.1f}")

    # ---- speculative decode at full width, graphed
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    out = {}
    for k in DRAFT_LENS:
        eng = Engine(cfg, params, device="cuda", spec_decode=True,
                     draft_len=k, **SERVE_KW)
        counter = hdp_paged_fum_decode.runs.tensor("cuda")
        rounds = []    # (width, FUM runs before, after) per round
        run_once = eng._run

        def marking(key, body, width, _run=run_once, _rounds=rounds):
            # the FUM kernel's count on the card, copied on the stream
            # (no wait for the card) before and after each round: the
            # runs between are that round's, its capture's warm-up
            # included
            before = counter.clone()
            _run(key, body, width)
            _rounds.append((key, before, counter.clone()))

        eng._run = marking
        tok, s, wall, launches, runs = serve(torch, eng, prompts, 32)
        del eng._run       # the closure holds the engine: free it with del
        label = f"spec decode, draft_len {k}, graphed"
        bad = first_divergence(tok, h1_tokens)
        check(not bad, f"{label}: tokens differ from the graphed horizon-1 "
              f"engine's (uid: first index, spec, horizon 1): {bad}")
        check(s["attn_decode_stage3"] == s["attn_verify_stage3"]
              == "cuda:hdp_paged_fum_decode",
              f"{label}: verify stage 3 resolved to "
              f"{s['attn_verify_stage3']}")
        rl = s["round_launches"]
        graphs = {w: n for w, (_, n) in eng._graphs.items()}
        check(all(v["draft"]["fum_kernel_launches"] == 0
                  and v["verify"]["fum_kernel_launches"] == N_LAYERS_QWEN
                  for v in rl.values())
              and all(g["fum_kernel_launches"] == N_LAYERS_QWEN
                      for g in graphs.values())
              and s["fum_kernel_launches"] == N_LAYERS_QWEN
              * s["spec_rounds"],
              f"{label}: FUM launches per round part {rl}, per graph "
              f"{graphs}, {s['fum_kernel_launches']} over "
              f"{s['spec_rounds']} rounds; expected {N_LAYERS_QWEN} a "
              "verify and none in the draft steps")
        # the FUM kernel's runs on the card, by the width of the round
        # they ran in: each round replays its width's graph, and the
        # first round of a width also runs the capture's warm-up
        widths, per_width = [w for w, _, _ in rounds], Counter()
        for w, before, after in rounds:
            per_width[w] += int((after - before).item())
        del rounds
        want = {w: graphs[w]["fum_kernel_launches"] * (widths.count(w) + 1)
                for w in set(widths)}
        want_all = N_LAYERS_QWEN * (s["spec_rounds"] + s["graph_captures"])
        check(per_width == want and runs["fum"] == want_all
              == sum(per_width.values()) and runs["block"] == 0,
              f"{label}: the kernel counted {runs['fum']} FUM runs on the "
              f"card, {dict(per_width)} by round width, over "
              f"{len(widths)} rounds; the engine counted {want} (its "
              f"graph's launches x (rounds + 1 warm-up)), {want_all} in "
              f"all ({N_LAYERS_QWEN} x ({s['spec_rounds']} rounds + "
              f"{s['graph_captures']} warm-up rounds)); block tile runs "
              f"{runs['block']}")
        log(f"[spec] {label}: {runs['fum']} FUM runs on the card = "
            f"{N_LAYERS_QWEN} layers x ({s['spec_rounds']} verifies + "
            f"{s['graph_captures']} warm-up rounds), by round width "
            f"{dict(sorted(per_width.items()))} = the engine's count")
        check(s["spec_graphs"] == len(set(widths)) <= k
              and s["graph_captures"] == s["spec_graphs"],
              f"{label}: {s['spec_graphs']} graphs for widths "
              f"{sorted(set(widths))}")
        log(f"[spec] {label}: "
            f"tokens == graphed horizon 1's; wall {wall:.2f} s, rounds "
            f"{s['spec_rounds']} (widths {dict(sorted(Counter(widths).items()))}), "
            f"acceptance_rate {s['acceptance_rate']:.4f}, decode_tok_s "
            f"{s['decode_tok_s']:.1f} (without the captures "
            f"{s['decode_tok_s_steady']:.1f}), graphs {s['spec_graphs']} "
            f"captured in {s['graph_capture_s']:.2f} s holding "
            f"{s['graph_allocated_bytes'] / 2**20:.1f} MiB allocated / "
            f"{s['graph_reserved_bytes'] / 2**20:.1f} MiB reserved; FUM "
            f"launches per round: draft {rl[k]['draft']['fum_kernel_launches']}, "
            f"verify {rl[k]['verify']['fum_kernel_launches']}; backends "
            f"draft {s['attn_backend_draft']} ({s['attn_draft_stage3']}), "
            f"verify {s['attn_backend_verify']}")
        # the kernel's runs at Sq = k on the card
        launched = per_width[k]
        del eng
        # the FUM kernel at the path's own verify calls: the same serve
        # eagerly, recording the call that listed the most pages
        eng = Engine(cfg, params, device="cuda", spec_decode=True,
                     draft_len=k, cuda_graph=False, **SERVE_KW)
        rec = Recorder(hdp_paged_fum_decode, key=listed_pages_verify,
                       clone=True)
        attention.hdp_paged_fum_decode = rec
        try:
            etok, es, ewall, _, eruns = serve(torch, eng, prompts, 32)
        finally:
            attention.hdp_paged_fum_decode = hdp_paged_fum_decode
        del eng
        check(etok == tok, f"draft_len {k}: eager tokens differ from the "
              "graphed run's")
        check(eruns["fum"] == es["fum_kernel_launches"]
              == N_LAYERS_QWEN * es["spec_rounds"],
              f"draft_len {k}, eager: {eruns['fum']} FUM runs on the card, "
              f"the engine counted {es['fum_kernel_launches']} over "
              f"{es['spec_rounds']} rounds")
        log(f"[spec] draft_len {k}, eager: tokens == graphed; decode_tok_s "
            f"{es['decode_tok_s']:.1f}, rounds {es['spec_rounds']}")
        out[k] = (launched, check_verify_call(
            torch, f"draft_len {k}", rec))
        del rec

    # ---- the model-dtype ("fp32") pool and its fraction copy, 8 layers
    nl = FP32_POOL_LAYERS
    cut = cfg.replace(n_layers=nl)
    p8 = {**params, "layers": _tree_map(lambda t: t[:nl], params["layers"])}
    runs = {}
    for spec in (False, True):
        eng = Engine(cut, p8, device="cuda", attn=AttnSpec(kv_dtype="fp32"),
                     spec_decode=spec, draft_len=4, **SERVE_KW)
        runs[spec] = serve(torch, eng, prompts, 32)[:2]
        if spec:
            check("f_scout" in eng.pages.cache,
                  "the speculating fp32 pool has no fraction copy")
        del eng
    bad = first_divergence(runs[True][0], runs[False][0])
    check(not bad, f"fp32 pool, {nl} layers: spec tokens differ from "
          f"horizon 1's: {bad}")
    log(f"[spec] fp32 (bf16) pool with f_scout, {nl} layers, draft_len 4: "
        f"tokens == horizon 1's; acceptance_rate "
        f"{runs[True][1]['acceptance_rate']:.4f}, cache_bytes_per_token "
        f"{runs[True][1]['cache_bytes_per_token']} (without the fraction "
        f"copy {runs[False][1]['cache_bytes_per_token']})")

    # ---- the reduced config, both features, card (graphed) vs CPU
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=96, prefill_buckets=(16, 32),
              prefix_cache=True, spec_decode=True, draft_len=4)
    gpu = Engine(small, device="cuda", seed=1, **kw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **kw)
    prng = np.random.default_rng(17)
    shared = prng.integers(1, 250, size=16).tolist()
    sp = [shared + prng.integers(1, 250, size=4 + i).tolist()
          for i in range(3)] + [shared[:12],
                                shared * 2 + prng.integers(1, 250, 8).tolist()]
    toks, sums = [], []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
        sums.append(e.summary())
    check(toks[0] == toks[1], f"reduced qwen2 with prefix cache and spec "
          f"decode: card tokens differ from the CPU's: {toks[0]} vs "
          f"{toks[1]}")
    check(sums[0]["prefix_hits"] == sums[1]["prefix_hits"] > 0
          and sums[0]["spec_graphs"] > 0,
          f"reduced qwen2: card {sums[0]['prefix_hits']} hits, "
          f"{sums[0]['spec_graphs']} graphs; CPU {sums[1]['prefix_hits']}")
    log(f"[spec] reduced qwen2-1.5b, prefix cache + spec decode (draft_len "
        f"4, one prompt chunked): card tokens (graphed) == CPU tokens; "
        f"hits {sums[0]['prefix_hits']}, acceptance_rate "
        f"{sums[0]['acceptance_rate']:.4f}")
    return out


# ------------------------------------------- phase 5b: granite-8b serving
N_LAYERS_GRANITE = 36
GRANITE_KW = dict(max_batch=8, max_len=4096 + 32,
                  prefill_buckets=(1024, 2048, 4096), collect_stats=True)


def granite_runs(cfg):
    """(label, config, attn spec, decode backend, decode stage 3, the FUM
    kernel's pool format or None) of each serving route on granite-8b."""
    from repro_torch.attention import AttnSpec
    off = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    fum = "cuda:hdp_paged_fum_decode"
    return [
        ("int8 grid pool", cfg, AttnSpec(kv_dtype="int8"),
         "pallas_paged_decode", fum, "int8"),
        ("fp8_v pool", cfg, AttnSpec(kv_dtype="fp8_v"),
         "pallas_paged_decode", fum, "fp8_v"),
        ("bf16 pool (kv_dtype fp32)", cfg, AttnSpec(kv_dtype="fp32"),
         "pallas_paged_decode", fum, "bf16"),
        ("int8 absmax pool", cfg, AttnSpec(kv_dtype="int8",
                                           kv_scale="absmax"),
         "pallas_paged_decode", "paged_hdp_decode", None),
        ("HDP off, paged int8 pool", off, AttnSpec(kv_dtype="int8"),
         "xla_dense", "xla_dense", None),
        ("HDP off, dense layout", off, AttnSpec(layout="dense"),
         "xla_dense", "xla_dense", None),
        ("HDP on, dense layout", cfg, AttnSpec(layout="dense"),
         "xla_hdp", "xla_hdp", None),
    ]


def phase_granite(torch):
    """granite-8b at full width (36 layers, bf16, seeded weights): 8
    requests of up to 4,096 prompt tokens and 32 new tokens on every
    serving route, eagerly and on the decode graph at horizon 4 with
    equal tokens; the FUM kernel's runs counted on the card. Then the
    reduced config on the card (graphed) against the CPU on each pool and
    layout. Returns the FUM kernel's runs on the card in the graphed
    serve of each pool format and a summary per route."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.serving import Engine, Request
    cfg = get_config("granite-8b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings)
          == (N_LAYERS_GRANITE, 4096, 32, 8, 128, 14336, 49152, False),
          f"unexpected granite-8b config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    log(f"[granite] bf16 weights ({cfg.param_count() / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(17)
    lens = [int(n) for n in rng.integers(256, 4097, size=7)] + [4096]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    log(f"[granite] prompt lengths {lens}")
    runs_by_fmt, routes = {}, {}
    for label, c, spec, backend, stage3, fmt in granite_runs(cfg):
        toks = {}
        for graphed in (False, True):
            torch.cuda.empty_cache()
            eng = Engine(c, params, device="cuda", attn=spec,
                         cuda_graph=graphed, decode_horizon=4 if graphed
                         else 1, **GRANITE_KW)
            tag = f"granite-8b {label}, " + (
                "graphed, horizon 4" if graphed else "eager, horizon 1")
            toks[graphed], s, wall, launches, runs = serve(
                torch, eng, prompts, 32)
            pools = {k: str(v.dtype).replace("torch.", "")
                     for k, v in eng._store.cache.items()}
            del eng
            log_served(tag, s, wall)
            log(f"[granite] {tag}: backends prefill "
                f"{s['attn_backend_prefill']} / decode "
                f"{s['attn_backend_decode']} (stage 3 "
                f"{s['attn_decode_stage3']}), layout {s['layout']}, "
                f"kv_dtype {s['kv_dtype']}, kv_scale {s['kv_scale']}, "
                f"pools {pools}, cache_bytes_per_token "
                f"{s['cache_bytes_per_token']}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check(s["attn_backend_decode"] == backend
                  and s["attn_decode_stage3"] == stage3,
                  f"{tag}: decode resolved to {s['attn_backend_decode']} "
                  f"(stage 3 {s['attn_decode_stage3']}), expected "
                  f"{backend} ({stage3})")
            if fmt is not None:
                check_decode_launches(s, launches, "fum", tag, runs,
                                      n_layers=N_LAYERS_GRANITE)
                got = launches["fum_format"]
                check(got[fmt] == sum(got.values()),
                      f"{tag}: FUM launches by format {got}, expected "
                      f"all {fmt}")
                if graphed:
                    runs_by_fmt[fmt] = runs["fum"]
            else:
                check(s["fum_kernel_launches"] == 0
                      and not any(launches["fum"].values())
                      and runs["fum"] == 0,
                      f"{tag}: the FUM kernel ran ({launches['fum']}, "
                      f"{runs['fum']} runs on the card)")
            routes.setdefault(label, {})["graphed" if graphed else "eager"] \
                = {k: s[k] for k in ("decode_tok_s", "decode_tok_s_steady",
                                     "prefill_s", "cache_bytes_per_token")}
        check(toks[True] == toks[False],
              f"granite-8b {label}: graphed tokens differ from the eager "
              f"run's: {toks[True]} vs {toks[False]}")
        log(f"[granite] {label}: graphed horizon-4 tokens == eager")
    del params
    torch.cuda.empty_cache()

    # agreement with a reference on a small input: reduced granite on
    # the card (graphed, kernels) and on the CPU (plain versions), same
    # weights, on every pool and layout of the routes above
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    prng = np.random.default_rng(4)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(3)] + [prng.integers(1, 250, size=40).tolist()]
    for label, c, spec, *_ in granite_runs(small):
        gpu = Engine(c, device="cuda", seed=2, attn=spec, decode_horizon=4,
                     **kw)
        cpu = Engine(c, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", attn=spec, **kw)
        toks = []
        for e in (gpu, cpu):
            for uid, p in enumerate(sp):
                e.submit(Request(uid, p, max_new_tokens=8))
            toks.append({u: r.tokens for u, r in e.run().items()})
        check(toks[0] == toks[1], f"reduced granite-8b {label}: card tokens "
              f"{toks[0]} != CPU tokens {toks[1]}")
        log(f"[granite] reduced granite-8b {label}: card tokens (graphed, "
            "horizon 4) == CPU plain-path tokens")
    return runs_by_fmt, routes


# ----------------------------------- phase 5c: windowed decode (h2o-danube)
def phase_window(torch):
    """h2o-danube-1.8b at full width, cut to 4 layers, with its sliding
    window cut to 512 so that prompts of 600-1,000 tokens run past it:
    the paged decode resolves to ``paged_hdp_decode`` (the kernels cannot
    express the window's lower bound), eagerly and graphed with equal
    tokens; the reduced config (window 16) card vs CPU."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.serving import Engine, Request
    full = get_config("h2o-danube-1.8b")
    check(full.sliding_window == 4096, f"unexpected h2o-danube {full}")
    cfg = full.replace(n_layers=4, sliding_window=512)
    params = registry.init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(600, 1001, size=4)]
    kw = dict(max_batch=4, max_len=1056, prefill_buckets=(256, 512, 1024),
              collect_stats=True)
    toks = {}
    for graphed in (False, True):
        eng = Engine(cfg, params, device="cuda", cuda_graph=graphed,
                     decode_horizon=4 if graphed else 1, **kw)
        toks[graphed], s, wall, launches, _ = serve(torch, eng, prompts, 16)
        del eng
        tag = ("h2o-danube-1.8b (4 layers, window 512), "
               + ("graphed, horizon 4" if graphed else "eager"))
        log_served(tag, s, wall)
        check(s["attn_backend_decode"] == "paged_hdp_decode"
              and s["fum_kernel_launches"] == 0,
              f"{tag}: decode resolved to {s['attn_backend_decode']}, FUM "
              f"launches {s['fum_kernel_launches']}")
        log(f"[window] {tag}: decode {s['attn_backend_decode']}, prompts "
            f"{[len(p) for p in prompts]} > window {cfg.sliding_window}")
    check(toks[True] == toks[False],
          "h2o-danube: graphed tokens differ from the eager run's")
    del params
    small = reduced(full)
    gkw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    gpu = Engine(small, device="cuda", seed=3, decode_horizon=4, **gkw)
    cpu = Engine(small, {k: _tree_to(v, "cpu") for k, v in
                         gpu.params.items()}, device="cpu", **gkw)
    prng = np.random.default_rng(6)
    sp = [prng.integers(1, 250, size=int(n)).tolist() for n in (20, 30, 40)]
    out = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        out.append({u: r.tokens for u, r in e.run().items()})
    check(out[0] == out[1], f"reduced h2o-danube: card tokens {out[0]} != "
          f"CPU tokens {out[1]}")
    log(f"[window] reduced h2o-danube (window {small.sliding_window}, "
        f"prompts {[len(p) for p in sp]}): card tokens (graphed) == CPU")


def _tree_to(tree, dev):
    return _tree_map(lambda t: t.to(dev), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------ phase 6
def time_ms(torch, fn, iters, flush):
    """Median device time of fn over `iters` runs, L2 flushed before each
    (the decode finds a layer's pages cold: 28 layers of pool exceed L2).
    The host enqueues each run behind a ~1 ms device spin, so the events
    bracket the run's device work and not the host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def fum_bound(torch, c):
    """Least time for the work this input needs: the K/V bytes of every
    (row, head, page) some query row keeps plus the small inputs and the
    output, against the flops of the scores and p.V of kept rows, priced
    as the block kernel's bound prices them: qq.K and frac(qq).frac(K)
    take operands on the Q4.12 grid or int8 codes, which split exactly
    into bf16 limbs (the bf16 tensor rate); p.V is at the bf16 rate
    where p is rounded to bf16 (a bf16 pool) and at the fp32 rate
    otherwise (p stays fp32 against the dequantized V)."""
    B, N, G, Sq, hd = c["qq"].shape
    ps = c["k_pool"].shape[1]
    item = c["k_pool"].element_size()
    counts = c["counts"].cpu()
    keep = c["keep"].cpu().bool()                   # [B,mk,N,G,Sq]
    mk = keep.shape[1]
    listed = torch.arange(mk)[None, :] < counts[:, None]        # [B,mk]
    head_page = keep.flatten(3).any(-1) & listed[:, :, None]    # [B,mk,N]
    kept_rows = int((keep & listed[:, :, None, None, None]).sum())
    nbytes = int(head_page.sum()) * ps * hd * 2 * item
    if c["k_scale"] is not None:
        nbytes += int(head_page.sum()) * 2 * 4
    for name in ("qq", "page_ids", "logical", "counts", "keep", "kv_len"):
        nbytes += c[name].numel() * c[name].element_size()
    nbytes += c["qq"].numel() * 4                            # output
    score_flops = kept_rows * ps * 4 * hd   # qk, fq.fk: 2 flops per MAC
    pv_flops = kept_rows * ps * 2 * hd
    pv_peak = BF16_FLOP_S if c["v_pool"].dtype == torch.bfloat16 \
        else FP32_FLOP_S
    flops = score_flops + pv_flops
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = score_flops / BF16_FLOP_S + pv_flops / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def fum_variant(torch, c, fmt):
    """The timing case's pools in another format, holding the same
    values where the format can: fp8 V pages (scale 1.0) of the decoded
    V, or the decoded K and V in bf16 (exact: codes x 2^-3)."""
    from repro_torch.core.quant import decode_pool, to_fp8_e4m3
    k = decode_pool(c["k_pool"], c["k_scale"][:, None, :, None])
    v = decode_pool(c["v_pool"], c["v_scale"][:, None, :, None])
    if fmt == "fp8_v":
        return dict(c, v_pool=to_fp8_e4m3(v),
                    v_scale=torch.ones_like(c["v_scale"]), fmt=fmt)
    return dict(c, k_pool=k.to(torch.bfloat16), v_pool=v.to(torch.bfloat16),
                k_scale=None, v_scale=None, fmt=fmt)


def phase_timing(torch, c):
    """The FUM decode at the timing case, split across blocks
    (``fum_splits``' S) and in one pass (S = 1), in turns with the plain
    version; then at the verify shape (Sq 4 and 8, the same widths and
    page density); then the fp8-V and bf16 pool variants at the timing
    case, split. Returns {mode, "verify<Sq>" or format: (kernel ms, plain
    ms, bound ms, bound by)}."""
    from repro_torch.kernels.hdp_paged_decode import (fum_splits,
                                                      hdp_paged_fum_decode)
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    args, kws = kernel_args(c)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    bound, bound_by, nbytes, flops = fum_bound(torch, c)
    B, N = c["qq"].shape[:2]
    S = fum_splits(B, N, c["page_ids"].shape[1],
                   torch.cuda.get_device_properties(0).multi_processor_count)
    p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws), 5,
                   flush)
    res = {}
    for mode, splits in (("split", None), ("single", 1)):
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(
            *args, **kws, splits=splits), 50, flush)
        res[mode] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [{mode}, S={splits or S}] at B8 "
            f"N2 G6 Sq1 hd128 ps128 (pages listed per row "
            f"{c['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
            f"{flops} flop)")
    for Sq in (4, 8):
        # the verify shape: the timing case's widths at Sq query rows
        cv = to_dev(make_case(torch, B=8, N=2, G=6, Sq=Sq, hd=128, ps=128,
                              nP=16, fmt="int8", live=0.5, seed=7), "cuda")
        args, kws = kernel_args(cv)
        bound, bound_by, nbytes, flops = fum_bound(torch, cv)
        p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws),
                       5, flush)
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                       flush)
        res[f"verify{Sq}"] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [verify, Sq={Sq}, split, S={S}] "
            f"at B8 N2 G6 hd128 ps128 (pages listed per row "
            f"{cv['counts'].tolist()}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}: {nbytes} B, "
            f"{flops} flop)")
    for fmt in ("fp8_v", "bf16"):
        cv = fum_variant(torch, c, fmt)
        args, kws = kernel_args(cv)
        bound, bound_by, nbytes, flops = fum_bound(torch, cv)
        p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws),
                       5, flush)
        k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                       flush)
        res[fmt] = (k_ms, p_ms, bound, bound_by)
        log(f"[timing] hdp_paged_fum_decode [{fmt} pool, split, S={S}] at "
            f"the same case: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {bound:.6f} ms ({bound_by}: {nbytes} B, {flops} flop)")
    return res


def scout_bound(torch, iq, ik, kw):
    """Least time for the scout's work on these inputs: IQ and IK read
    once, theta and keep written once, against one int8 multiply-add per
    (valid row, valid col, d) at the card's int8 rate."""
    B, H, Sq, hd = iq.shape
    Sk = ik.shape[2]
    nq, nk = -(-Sq // kw["block_q"]), -(-Sk // kw["block_k"])
    rows = torch.arange(Sq, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=Sk).sum()) if kw["causal"] \
        else float(Sq * Sk)
    nbytes = (iq.numel() + ik.numel()) * 4 + B * H * nq * nk * 5 + B * H * 4
    ops = B * H * pairs * hd * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def block_bound(torch, args, kw):
    """Least time for the block kernel's work on these inputs: the valid
    (row, col) pairs of every listed block of a kept head, 2 flops per
    pair and d for each product, against Q read once, every listed K/V
    block read once and the output written. q.k and fq.fk take operands
    on the Q4.12 grid, which split exactly into bf16 limbs: the bf16
    tensor rate. p.v has V's type, since p is rounded to it (bf16 V: the
    bf16 tensor rate; fp32 V: the fp32 rate)."""
    q, k, v, idx, cnt, hk = args
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    bq, bk = kw["block_q"], kw["block_k"]
    nq, mk = idx.shape[2], idx.shape[3]
    live = (torch.arange(mk, device=idx.device) < cnt[..., None]) \
        & hk[..., None, None].bool()
    ent = torch.nonzero(live)                           # [E, 4] b,h,i,j
    blk = idx[ent[:, 0], ent[:, 1], ent[:, 2], ent[:, 3]].long()
    row = ent[:, 2:3] * bq + torch.arange(bq, device=idx.device)   # [E,bq]
    c_lo = (blk * bk)[:, None]
    c_hi = torch.clamp((blk + 1) * bk, max=Sk)[:, None]
    if kw.get("kv_len") is not None:
        lens = kw["kv_len"][ent[:, 0], ent[:, 1]].long()[:, None]
        c_hi = torch.minimum(c_hi, lens)
    hi = torch.minimum(c_hi, row + 1) if kw.get("causal", True) else \
        c_hi.expand_as(row)
    pairs = float(torch.where(row < Sq, torch.clamp(hi - c_lo, min=0),
                              0).sum())
    score_flops = pairs * hd * (4 if kw.get("approx", True) else 2)
    pv_flops = pairs * hd * 2
    pv_peak = BF16_FLOP_S if v.dtype == torch.bfloat16 else FP32_FLOP_S
    flops = score_flops + pv_flops
    listed = torch.zeros(B, H, -(-Sk // bk), dtype=torch.bool,
                         device=idx.device)
    listed[ent[:, 0], ent[:, 1], blk] = True
    nbytes = q.numel() * 4 * 2 + int(listed.sum()) * bk * hd * (
        k.element_size() + v.element_size()) \
        + (idx.numel() + cnt.numel() + hk.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = score_flops / BF16_FLOP_S + pv_flops / pv_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_bound(torch, q, k, v, causal):
    """Least time for flash on these inputs: q, k, v read once and the
    output written, against 4 flops per valid (row, col) pair and d
    (q.k and p.v) at the bf16 tensor-core rate (fp32 inputs: the fp32
    rate)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    rows = torch.arange(Sq, dtype=torch.float64)
    pairs = float(torch.clamp(rows + 1, max=Sk).sum()) if causal \
        else float(Sq * Sk)
    flops = B * H * pairs * hd * 4
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_FLOP_S if q.dtype == torch.bfloat16 else FP32_FLOP_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_timing_prefill(torch, calls, block_tile_call):
    """The scout, block and flash kernels at the aligned prefill's own
    inputs (block and flash on the tensor-core path): kernel, plain
    version, bound and (flash) the PyTorch SDPA call as a yardstick; the
    tile paths at the decode route's block call and at the prefill's
    flash inputs in fp32. Returns {entry name: (kernel ms, plain ms,
    bound ms, bound by, bytes, ops, library ms)}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hdp_block_attn import hdp_block_sparse_attention
    from repro_torch.kernels.hdp_scout import hdp_scout
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         hdp_block_sparse_attention_plain,
                                         hdp_scout_plain)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    res = {}
    (iq, ik), kw = calls["scout"]
    scout_plain_ms = time_ms(torch, lambda: hdp_scout_plain(iq, ik, **kw), 3,
                             flush)
    for name, path in (("hdp_scout", None), ("hdp_scout[dp4a]", "dp4a")):
        res[name] = (
            time_ms(torch, lambda: hdp_scout(iq, ik, path=path, **kw), 20,
                    flush),
            scout_plain_ms, *scout_bound(torch, iq, ik, kw), None)
    for name, (args, kw) in (("hdp_block_sparse_attention", calls["block"]),
                             ("hdp_block_sparse_attention[tile]",
                              block_tile_call)):
        res[name] = (
            time_ms(torch, lambda: hdp_block_sparse_attention(*args, **kw),
                    10, flush),
            time_ms(torch, lambda: hdp_block_sparse_attention_plain(
                *args, **kw), 3, flush),
            *block_bound(torch, args, kw), None)
    (q, k, v), kw = calls["flash"]
    for name, dt in (("flash_attention", q.dtype),
                     ("flash_attention[tile]", torch.float32)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        res[name] = (
            time_ms(torch, lambda: flash_attention(qd, kd, vd, **kw), 10,
                    flush),
            time_ms(torch, lambda: flash_attention_plain(qd, kd, vd, **kw), 3,
                    flush),
            *flash_bound(torch, qd, kd, vd, kw["causal"]),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                qd, kd, vd, is_causal=kw["causal"]), 20, flush))
    for name, (k_ms, p_ms, bound, by, nbytes, ops, lib) in res.items():
        where = ("the decode route's call" if name ==
                 "hdp_block_sparse_attention[tile]" else
                 "the aligned prefill's inputs")
        log(f"[timing] {name} at {where}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.6f} ms "
            f"({by}: {nbytes} B, {ops:.4g} ops)"
            + (f", scaled_dot_product_attention {lib:.4f} ms"
               if lib is not None else ""))
    return res


# ------------------------------------------------------------------ main
def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL: the port's package is missing ({SRC / 'repro_torch'});"
              " run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        with torch.inference_mode():
            name, smi_line = phase_env(torch)
            phase_build()
            fum_err, main_case = phase_kernels(torch)
            phase_new_kernels(torch)
            from repro_torch.configs import get_config
            from repro_torch.models import registry
            cfg = get_config("qwen2-1.5b")
            check(cfg.n_layers == N_LAYERS_QWEN, "unexpected qwen2-1.5b depth")
            t0 = time.perf_counter()
            params = registry.init_params(cfg, 0, "cuda")
            torch.cuda.synchronize()
            log(f"[model] qwen2-1.5b bf16 weights "
                f"({cfg.param_count() / 1e9:.2f} B params) initialised in "
                f"{time.perf_counter() - t0:.1f} s")
            prefill_launches, calls = phase_aligned_prefill(
                torch, cfg, params)
            serve_launches, path_err, block_tile_call = \
                phase_serving(torch, cfg, params)
            verify = phase_spec_prefix(torch, cfg, params,
                                       serve_launches["h1_tokens"])
            del params
            fum_by_fmt, granite = phase_granite(torch)
            phase_window(torch)
            fum_timed = phase_timing(torch, main_case)
            timed = phase_timing_prefill(torch, calls, block_tile_call)
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for mode in ("split", "single"):
        k_ms, p_ms, bound, bound_by = fum_timed[mode]
        kernels.append({
            "name": "hdp_paged_fum_decode" + ("" if mode == "split"
                                             else "[single]"),
            "path": mode, "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": serve_launches["fum"][mode],
            "max_abs_err": max(fum_err[mode], path_err[mode]),
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
        })
    kernels[-1]["note"] = ("the one-pass mode (S = 1), the earlier design, "
                           "timed beside the split; fum_splits gives S > 1 "
                           "at every shape the main path runs")
    for Sq in DRAFT_LENS:
        k_ms, p_ms, bound, bound_by = fum_timed[f"verify{Sq}"]
        launched, err = verify[Sq]
        kernels.append({
            "name": f"hdp_paged_fum_decode[verify Sq={Sq}]", "path": "split",
            "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": launched, "max_abs_err": err,
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
            "note": f"the multi-query verify of a speculative round at "
                    f"draft_len {Sq}, timed at the int8 timing case's widths "
                    f"with {Sq} query rows; launches: 28 per round of width "
                    f"{Sq} over the graphed draft_len-{Sq} serve, its "
                    "capture's warm-up round included",
        })
    for fmt in ("fp8_v", "bf16"):
        k_ms, p_ms, bound, bound_by = fum_timed[fmt]
        kernels.append({
            "name": f"hdp_paged_fum_decode[{fmt}]", "path": "split",
            "route": "cuda",
            "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
            "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
            "launches": fum_by_fmt[fmt], "max_abs_err": fum_err[fmt],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_note": NO_LIBRARY_CALL["hdp_paged_fum_decode"],
            "note": f"the {fmt} pool format, timed at the int8 timing case's "
                    "values; launches over granite-8b's graphed serve on "
                    "that pool",
        })
    # entry: (path, source, TPU kernel, launches on the path that runs it)
    entries = {
        "hdp_scout": ("tensor_core", "hdp_scout_tc.cu", "hdp_scout.py:75",
                      prefill_launches["hdp_scout"]),
        "hdp_scout[dp4a]": ("dp4a", "hdp_scout.cu", "hdp_scout.py:75",
                            prefill_launches["hdp_scout[dp4a]"]),
        "hdp_block_sparse_attention": (
            "tensor_core", "hdp_block_attn_tc.cu", "hdp_block_attn.py:91",
            prefill_launches["hdp_block_sparse_attention"]),
        "flash_attention": (
            "tensor_core", "flash_attention_tc.cu", "flash_attention.py:69",
            prefill_launches["flash_attention"]),
        "hdp_block_sparse_attention[tile]": (
            "tile", "hdp_block_attn.cu", "hdp_block_attn.py:91",
            serve_launches["block_tile"]),
        "flash_attention[tile]": (
            "tile", "flash_attention.cu", "flash_attention.py:69",
            prefill_launches["flash_attention[tile]"]),
    }
    for ename, (path, src, tpu, n) in entries.items():
        k_ms, p_ms, bound, bound_by, _, _, lib_ms = timed[ename]
        kernels.append({
            "name": ename, "path": path, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": n, "max_abs_err": ERRS[ename],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })
        base = ename.split("[")[0]
        if base in NO_LIBRARY_CALL:
            kernels[-1]["library_note"] = NO_LIBRARY_CALL[base]
    log(f"[granite] routes {json.dumps(granite)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
