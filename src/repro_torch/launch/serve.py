"""Serve seeded random prompts through the port's engine and print its
summary as one JSON line.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8 --max-new 32

runs on the CUDA card (the default ``--device cuda`` raises without
one); ``--device cpu --reduced`` serves the tiny test-size config
through the plain kernel versions. ``--backend`` picks the attention
backend (a registry name or family tag, e.g. ``pallas_hdp_block`` for
the block-sparse kernel in decode; default ``auto``);
``--decode-horizon`` sets the engine's decode steps per host sync.
``--layout`` picks the paged pool (the default) or the dense slot cache,
``--kv-dtype`` the pool format (int8, fp8_v, or fp32: unquantized pages
in the model dtype) and ``--kv-scale`` its scales (grid or absmax);
``--no-hdp`` serves the same model with exact attention.
Weights are random, drawn from ``--seed``; prompt lengths are drawn
from [bucket/4, max_len - max_new] with the largest prefill bucket
(1024, or 32 with ``--reduced``; longer prompts prefill in chunks), and
``--max-len`` defaults to that bucket plus ``--max-new``.

    python -m repro_torch.launch.serve --arch granite-8b --kv-dtype fp8_v
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny reduced() config of --arch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    help="attention backend: a registry name, a family "
                         "tag (pallas | xla | reference) or auto")
    ap.add_argument("--decode-horizon", type=int, default=None,
                    help="decode steps per engine step and host sync "
                         "(one CUDA graph replay each on the card), "
                         "token-identical to 1; default honors "
                         "REPRO_DECODE_HORIZON, else 1")
    ap.add_argument("--max-len", type=int, default=None,
                    help="longest prompt + generation a slot holds")
    ap.add_argument("--no-hdp", action="store_true",
                    help="serve with exact attention (HDP off)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "paged", "dense"],
                    help="serving cache layout: the block-paged pool "
                         "(auto) or the dense per-slot cache")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "fp32", "int8", "fp8_v"],
                    help="paged pool format: int8 codes, int8 K + fp8 V, "
                         "or unquantized pages in the model dtype (fp32); "
                         "auto honors REPRO_KV_DTYPE, else int8")
    ap.add_argument("--kv-scale", default="grid", choices=["grid", "absmax"],
                    help="quantized pool scales: the static power-of-two "
                         "grid or per-page absmax")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from repro_torch.attention import AttnSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.no_hdp:
        cfg = cfg.replace(hdp=cfg.hdp.replace(enabled=False))
    buckets = (16, 32) if args.reduced else (256, 512, 1024)
    max_len = args.max_len or buckets[-1] + args.max_new
    hi = max_len - args.max_new
    lo = min(buckets[-1] // 4, hi)
    if hi < 1:
        raise SystemExit(f"--max-len {max_len} leaves no room for a prompt "
                         f"beside --max-new {args.max_new}")
    spec = AttnSpec(backend=args.backend, layout=args.layout,
                    kv_dtype=args.kv_dtype, kv_scale=args.kv_scale)
    eng = Engine(cfg, seed=args.seed, device=args.device,
                 max_batch=args.max_batch, max_len=max_len,
                 prefill_buckets=buckets, collect_stats=True, attn=spec,
                 decode_horizon=args.decode_horizon)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        n = int(rng.integers(lo, hi + 1))
        eng.submit(Request(uid, rng.integers(1, cfg.vocab_size, n).tolist(),
                           max_new_tokens=args.max_new))
    results = eng.run()
    summary = eng.summary()
    # order-independent fingerprint of every generated token
    summary["tokens_fp"] = int(np.sum([
        (uid + 1) * (i + 1) * (t + 1) for uid, r in results.items()
        for i, t in enumerate(r.tokens)]) % (2 ** 31))
    print(json.dumps(summary, default=str))
    return 0 if summary["completed"] == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
