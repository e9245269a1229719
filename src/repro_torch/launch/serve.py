"""Serve seeded random prompts through the port's engine and print its
summary as one JSON line.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 8 --max-new 32

runs on the CUDA card (the default ``--device cuda`` raises without
one); ``--device cpu --reduced`` serves the tiny test-size config
through the plain kernel versions. ``--backend`` picks the attention
backend (a registry name or family tag, e.g. ``pallas_hdp_block`` for
the block-sparse kernel in decode; default ``auto``);
``--decode-horizon`` sets the engine's decode steps per host sync.
Weights are random, drawn from ``--seed``; prompt lengths are drawn
from [bucket/4, bucket] of the largest prefill bucket (1024, or 32 with
``--reduced``).
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
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    buckets = (16, 32) if args.reduced else (256, 512, 1024)
    hi = buckets[-1]
    lo = hi // 4
    eng = Engine(cfg, seed=args.seed, device=args.device,
                 max_batch=args.max_batch, max_len=hi + args.max_new,
                 prefill_buckets=buckets, collect_stats=True,
                 attn=args.backend, decode_horizon=args.decode_horizon)
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
