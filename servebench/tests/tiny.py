"""A cell at the reduced shapes the CPU runs: the configuration file's
keys filled from the program's ``reduced`` config, a small engine and a
small session mix."""
import dataclasses
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from servebench.run import Cell

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(arch: str, dtype: str, l0: int, share: float, gap: float):
    """The cell and its config; its limits: ``l0`` on layer 0's differing
    codes, ``share`` on every later layer's share, ``gap`` on the widest
    logit gap."""
    cfg = reduced(get_config(arch)).replace(dtype=dtype, capacity_factor=1.25)
    keys = json.loads((ROOT / "servebench" / "configs" / f"{arch}.json")
                      .read_text())["model"].keys()
    conf = {"name": arch, "port_config": arch,
            "model": {k: getattr(cfg, k) for k in keys},
            "hdp": dataclasses.asdict(cfg.hdp),
            "engine": {"max_batch": 4, "max_len": 64,
                       "prefill_buckets": [8, 16, 32], "decode_horizon": 4,
                       "kv_dtype": "int8", "kv_scale": "grid",
                       "num_pages": 160, "prefix_cache": True,
                       "stream_sched": True}}
    traffic = {"clients": 4, "turns": 3, "stagger_turns": True,
               "shared_len": {"dist": "uniform", "min": 8, "max": 40},
               "prompt_len": {"dist": "uniform", "min": 2, "max": 6},
               "answer_len": {"dist": "uniform", "min": 3, "max": 8},
               "pool": 16, "sizes_seed": 5, "ramp_completions": 4}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    lim = {"kv_mismatch_l0": l0,
           **{f"kv_share_l{i}": share for i in range(1, cfg.n_layers)},
           "logit_gap_max": gap}
    return Cell(f"tiny-{arch}", conf, traffic, lim, bench["end_to_end"],
                bench["per_layer"], 1), cfg
