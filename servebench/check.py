"""The check of what the timed path produced, against the plain reference.

The requests read for the check are drawn from the seed as they finish
inside the run (the longest request sent in the window always among
them, then others until some hundreds of served tokens): their pool
pages, every layer's int8 codes of K and V, are read before the engine
frees them. After the window ``reference.model.pool_check`` follows each
from its prompt, its served tokens and the weights, with the pool's K/V
as every attention's context, and gives the numbers:

* ``kv_mismatch_l0``: layer 0's codes that differ, at every position (a
  position's layer-0 K/V depend on its token alone);
* ``kv_share_l<i>``: the share of layer ``i``'s codes that differ, at
  the request's own prefill rows and every decode step;
* ``logit_gap_max`` and ``logit_gap_mean``: the widest and the mean gap
  by which a served token's logit lies below the reference's best logit
  at its decode step;
* ``top1_miss_share``: the share of steps whose served token is not the
  reference's first.

A cell compares the numbers its limits file (``limits/<cell>.json``)
names, each against its limit; the others are printed for the record.

The control (``control_numbers``) puts the reference one precision below
the configuration's in the program's place: its codes against the
pool's, and the gap, under the reference's logits, of the token it ranks
first at each step. It is run by ``calibrate.py``, never by a benchmark
run.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from servebench.reference.model import BELOW, PoolSeq, Prec, Shapes, pool_check


def pool_seqs(load, records: Dict) -> List[PoolSeq]:
    """The requests whose pool codes the run read, accounted for, in the
    order they were read."""
    out = []
    for uid, (k, v, ks, vs) in load.pool.items():
        r = records[uid]
        if not r.accounted:
            continue
        out.append(PoolSeq(uid, r.prompt, r.calls,
                           np.asarray(r.result.tokens, np.int64), k, v, ks, vs,
                           load.page))
    return out


def _gaps(ref: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(1, toks[:, None])[:, 0]


def numbers(W, conf: Dict, seqs: Sequence[PoolSeq], prec: Prec, device,
            judge: Optional[Dict[int, torch.Tensor]] = None) -> Dict:
    """Every number of the check, with the logits of each sequence's
    steps (``logits``, by uid). The tokens judged are the served ones;
    with ``judge`` (the reference's logits, by uid) they are the ones
    this run's logits rank first, judged by ``judge``."""
    shp = Shapes.from_config(conf)
    L = shp.n_layers
    bad, tot = [0] * L, [0] * L
    logits: Dict[int, torch.Tensor] = {}
    gaps, miss = [], []
    for seq in seqs:
        per, lg = pool_check(W, shp, seq, prec, device)
        for i, (b, t) in enumerate(per):
            bad[i], tot[i] = bad[i] + b, tot[i] + t
        logits[seq.uid] = lg
        if judge is None:
            ref, toks = lg, torch.as_tensor(seq.decode, device=lg.device)
        else:
            ref, toks = judge[seq.uid], lg.argmax(-1)
        gaps.append(_gaps(ref, toks))
        miss.append(toks != ref.argmax(-1))
    out = {"kv_mismatch_l0": bad[0]}
    for i in range(1, L):
        out[f"kv_share_l{i}"] = bad[i] / tot[i] if tot[i] else float("inf")
    if gaps:
        g = torch.cat(gaps)
        out["logit_gap_max"] = float(g.max())
        out["logit_gap_mean"] = float(g.mean())
        out["top1_miss_share"] = float(torch.cat(miss).float().mean())
    else:
        out["logit_gap_max"] = out["logit_gap_mean"] = float("inf")
    out["tokens"] = sum(len(s.decode) for s in seqs)
    out["logits"] = logits
    return out


def control_numbers(W, conf: Dict, seqs: Sequence[PoolSeq], checked: Dict,
                    device) -> Dict:
    """The control's numbers: the reference one precision below the
    configuration's, judged by the reference's logits (``checked``)."""
    dtype = conf["model"]["dtype"]
    return numbers(W, conf, seqs, Prec(dtype, BELOW[dtype]), device,
                   judge=checked["logits"])
