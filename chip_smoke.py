#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and nvcc, and imports only the port (``src/repro_torch``),
never JAX nor the JAX package. Phases:

1. environment — card name and power limit (nvidia-smi);
2. build — every CUDA source of the serving path, one nvcc each;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the reference tests' small shapes and at qwen2-1.5b's full decode
   shape, on int8 and fp32 pools, with the no-read poison checks;
4. serving — qwen2-1.5b at full width (bf16, seeded random weights,
   int8 pool) serves 8 requests through ``Engine.submit``/``run``; the
   FUM kernel must have launched once per layer per decode step; a
   reduced config served on the card must give the CPU's tokens;
5. timing — each kernel and its plain version at the main path's shape
   (CUDA events, L2 flushed between launches) beside its bound.

Prints the per-kernel JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: NVIDIA H100 SXM data-sheet peaks (dense, at the full 700 W limit)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
ATOL = RTOL = 1e-4   # fp32 accumulation in both; only the sum order differs
N_LAYERS_QWEN = 28


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
    built = build.build_all(["hdp_paged_decode"])
    log(f"[build] {time.perf_counter() - t0:.2f} s for all sources")
    for name, rec in built.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


# ------------------------------------------------------------ phase 3
def make_case(torch, *, B, N, G, Sq, hd, ps, nP, quantized, live, seed):
    """Paged FUM decode inputs the way the serving path builds them: a
    pool whose rows own distinct pages, a keep mask, and the fetch list
    compressed by the model's own ``_fetch_list``."""
    from repro_torch.core.quant import pool_scale, quantize_fixed
    from repro_torch.models.attention import _fetch_list
    g = torch.Generator().manual_seed(seed)
    P = 1 + B * nP
    Sk = nP * ps
    qq = quantize_fixed(2.0 * torch.randn(B, N, G, Sq, hd, generator=g))
    if quantized:
        kp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, ps, N, hd), generator=g,
                           dtype=torch.int8)
        ks = torch.full((P, N), pool_scale(4))
        vs = torch.full((P, N), pool_scale(4))
    else:
        kp = 4.0 * torch.randn(P, ps, N, hd, generator=g)
        vp = torch.randn(P, ps, N, hd, generator=g)
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
                k_scale=ks, v_scale=vs, table=table, fetched=fetched)


def to_dev(case, dev):
    return {k: (v.to(dev) if v is not None else None)
            for k, v in case.items()}


def kernel_args(c):
    return ((c["qq"], c["k_pool"], c["v_pool"], c["page_ids"], c["logical"],
             c["counts"], c["keep"], c["kv_len"]),
            dict(k_scale=c["k_scale"], v_scale=c["v_scale"]))


def phase_kernels(torch):
    from repro_torch.core.quant import POISON_CODE
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    cases = []
    for quantized in (True, False):
        for Sq in (1, 3):
            cases.append((f"test B2N2G2Sq{Sq}hd8ps4 "
                          f"{'int8' if quantized else 'fp32'}",
                          dict(B=2, N=2, G=2, Sq=Sq, hd=8, ps=4, nP=8,
                               quantized=quantized, live=0.5, seed=Sq)))
        cases.append((f"qwen2 B8N2G6Sq1hd128ps128 "
                      f"{'int8' if quantized else 'fp32'}",
                      dict(B=8, N=2, G=6, Sq=1, hd=128, ps=128, nP=16,
                           quantized=quantized, live=0.5, seed=7)))
    worst, main_case = 0.0, None
    for label, kw in cases:
        c = to_dev(make_case(torch, **kw), "cuda")
        args, kws = kernel_args(c)
        out = hdp_paged_fum_decode(*args, **kws)
        ref = hdp_paged_fum_decode_ref(*args, **kws)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=ATOL, rtol=RTOL),
              f"{label}: kernel vs plain max |err| {err:.3e}")
        # pruned pages are never read: poisoning them (V codes and both
        # scales, or NaN fp32 K/V) leaves the output bit-identical
        pruned = c["table"][~c["fetched"]].long()
        check(pruned.numel() > 0, f"{label}: no pruned pages")
        kp, vp = c["k_pool"].clone(), c["v_pool"].clone()
        ks = vs = None
        if kw["quantized"]:
            vp[pruned] = POISON_CODE
            ks, vs = c["k_scale"].clone(), c["v_scale"].clone()
            ks[pruned] = float("nan")
            vs[pruned] = float("nan")
        else:
            kp[pruned] = float("nan")
            vp[pruned] = float("nan")
        out_bad = hdp_paged_fum_decode(
            c["qq"], kp, vp, *args[3:], k_scale=ks, v_scale=vs)
        check(torch.equal(out, out_bad),
              f"{label}: poison on pruned pages changed the output")
        # ... and poison on one fetched, visible page must surface as NaN
        ps = kw["ps"]
        mk = c["page_ids"].shape[1]
        seen = (torch.arange(mk, device=c["counts"].device)[None]
                < c["counts"][:, None]) \
            & (c["logical"] * ps < c["kv_len"][:, None])
        b, j = (int(x) for x in torch.nonzero(seen)[0])
        vis = int(c["page_ids"][b, j])
        kp, ks = c["k_pool"].clone(), None
        if kw["quantized"]:
            ks = c["k_scale"].clone()
            ks[vis] = float("nan")
        else:
            kp[vis] = float("nan")
        out_nan = hdp_paged_fum_decode(
            c["qq"], kp, c["v_pool"], *args[3:], k_scale=ks,
            v_scale=c["v_scale"])
        torch.cuda.synchronize()
        check(bool(torch.isnan(out_nan[b]).any()),
              f"{label}: NaN scale on a fetched page did not surface")
        log(f"[kernels] {label}: max |kernel - plain| {err:.3e}, "
            f"pages kept {int(c['counts'].sum())}/{c['table'].numel()}, "
            "poison checks ok")
        worst = max(worst, err)
        if label.startswith("qwen2") and kw["quantized"]:
            main_case = c
    return worst, main_case


# ------------------------------------------------------------ phase 4
def phase_serving(torch):
    import numpy as np
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    from repro_torch.serving import Engine, Request
    cfg = get_config("qwen2-1.5b")
    check(cfg.n_layers == N_LAYERS_QWEN, "unexpected qwen2-1.5b depth")
    t0 = time.perf_counter()
    eng = Engine(cfg, device="cuda", seed=0, max_batch=8, max_len=1056,
                 prefill_buckets=(256, 512, 1024), collect_stats=True)
    torch.cuda.synchronize()
    log(f"[serve] qwen2-1.5b bf16 weights ({cfg.param_count() / 1e9:.2f} B "
        f"params) initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(200, 1001, size=8)]
    # keep the inputs of every FUM call of the path, to hold the kernel
    # against its plain version on the one that kept the most pages (the
    # pool only grows past each call's kv_len, which the call masks)
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return hdp_paged_fum_decode(*args, **kw)

    torch.cuda.reset_peak_memory_stats()
    attention.hdp_paged_fum_decode = recording
    hdp_paged_fum_decode.launches = 0
    try:
        t0 = time.perf_counter()
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=32))
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = hdp_paged_fum_decode.launches
    finally:
        attention.hdp_paged_fum_decode = hdp_paged_fum_decode
    s = eng.summary()
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}")
    log(f"[serve] wall {wall:.2f} s, prefill_s {s['prefill_s']:.3f}, "
        f"decode_tok_s {s['decode_tok_s']:.1f}, decode_steps "
        f"{s['decode_steps']}, block/head/page sparsity "
        f"{s['block_sparsity']:.4f}/{s['head_sparsity']:.4f}/"
        f"{s['page_sparsity']:.4f}, cache_bytes_per_token "
        f"{s['cache_bytes_per_token']}, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[serve] summary {json.dumps(s, default=str)}")
    check(len(res) == 8 and all(r.complete and r.status == "ok"
                                for r in res.values()),
          f"not every request completed: "
          f"{[(u, r.status, r.error) for u, r in res.items()]}")
    check(all(len(r.tokens) == 32 and all(0 <= t < cfg.vocab_size
                                          for t in r.tokens)
              for r in res.values()), "wrong token counts or ids")
    check(s["attn_decode_stage3"].startswith("cuda"),
          f"decode stage 3 resolved to {s['attn_decode_stage3']}")
    check(launches == N_LAYERS_QWEN * s["decode_steps"] and launches > 0,
          f"FUM kernel launched {launches} times, expected "
          f"{N_LAYERS_QWEN} x {s['decode_steps']} decode steps")
    log(f"[serve] FUM kernel launches {launches} = {N_LAYERS_QWEN} layers "
        f"x {s['decode_steps']} decode steps")
    kept = torch.stack([args[5].sum() for args, _ in calls]).tolist()
    check(max(kept) > 0, "no FUM call of the path kept a page")
    args, kw = calls[max(range(len(calls)), key=kept.__getitem__)]
    calls.clear()
    out = hdp_paged_fum_decode(*args, **kw)
    ref = hdp_paged_fum_decode_ref(*args, **kw)
    torch.cuda.synchronize()
    path_err = (out - ref).abs().max().item()
    check(bool(torch.isfinite(out).all()) and torch.allclose(
        out, ref, atol=ATOL, rtol=RTOL),
        f"kernel vs plain at the path's own inputs: max |err| {path_err:.3e}")
    log(f"[serve] kernel vs plain at the path's call that kept the most "
        f"pages (qq {tuple(args[0].shape)}, page lists "
        f"{tuple(args[3].shape)}, {max(kept)} pages kept): max |err| "
        f"{path_err:.3e}")

    # agreement with a reference on a small input: the reduced config on
    # the card (kernel) and on the CPU (plain version), same weights
    small = reduced(cfg)
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32))
    gpu = Engine(small, device="cuda", seed=1, **kw)
    cpu_params = {k: _tree_to(v, "cpu") for k, v in gpu.params.items()}
    cpu = Engine(small, cpu_params, device="cpu", **kw)
    prng = np.random.default_rng(3)
    sp = [prng.integers(1, 250, size=int(prng.integers(4, 24))).tolist()
          for _ in range(4)]
    toks = []
    for e in (gpu, cpu):
        for uid, p in enumerate(sp):
            e.submit(Request(uid, p, max_new_tokens=8))
        toks.append({u: r.tokens for u, r in e.run().items()})
    check(toks[0] == toks[1], f"reduced qwen2 tokens differ card vs CPU: "
          f"{toks[0]} vs {toks[1]}")
    log("[serve] reduced qwen2-1.5b: card tokens == CPU plain-path tokens")
    return launches, path_err


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ------------------------------------------------------------ phase 5
def time_ms(torch, fn, iters, flush):
    """Median device time of fn over `iters` runs, L2 flushed before each
    (the decode finds a layer's pages cold: 28 layers of pool exceed L2)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
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
    output, against the flops of the scores and p.V of kept rows."""
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
    flops = kept_rows * ps * 6 * hd   # qk, fq.fk, p.v: 2 flops per MAC
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_timing(torch, c):
    from repro_torch.kernels.hdp_paged_decode import hdp_paged_fum_decode
    from repro_torch.kernels.ref import hdp_paged_fum_decode_ref
    args, kws = kernel_args(c)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    saved = hdp_paged_fum_decode.launches
    k_ms = time_ms(torch, lambda: hdp_paged_fum_decode(*args, **kws), 50,
                   flush)
    p_ms = time_ms(torch, lambda: hdp_paged_fum_decode_ref(*args, **kws), 5,
                   flush)
    hdp_paged_fum_decode.launches = saved     # timing launches do not count
    bound, bound_by, nbytes, flops = fum_bound(torch, c)
    log(f"[timing] hdp_paged_fum_decode at B8 N2 G6 Sq1 hd128 ps128: "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.6f} ms "
        f"({bound_by}: {nbytes} B, {flops} flop)")
    return k_ms, p_ms, bound, bound_by


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
            err, main_case = phase_kernels(torch)
            launches, path_err = phase_serving(torch)
            k_ms, p_ms, bound, bound_by = phase_timing(torch, main_case)
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "hdp_paged_fum_decode",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hdp_paged_decode.cu",
        "replaces": "src/repro/kernels/hdp_paged_decode.py:122",
        "launches": launches,
        "max_abs_err": max(err, path_err),
        "ms": k_ms,
        "kernel_ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
