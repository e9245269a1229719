"""BENCHMARK.json against the benchmark's contract, the files every cell
finds by its names, and each configuration file against the program's
registered config."""
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from servebench.run import Cell, port_config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["servebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200
               for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024
    n = len(BENCH["workloads"])
    # a full check with 24 cells must fit its 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


def test_names_units_and_entries():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(w["name"] for w in BENCH["workloads"])) == \
        len(BENCH["workloads"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("servebench/") and len(c["reduced"]) <= 16


@pytest.mark.parametrize("work", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(work):
    cell = Cell.load(work)
    assert cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert (ROOT / "servebench" / "metrics" / f"{m['name']}.py").is_file()
    # a limit for layer 0's codes, each later layer's share and the logits
    L = json.loads((ROOT / next(c["file"] for c in BENCH["configs"]
                                if c["name"] == cell.conf["name"]))
                   .read_text())["model"]["n_layers"]
    names = list(cell.limits)
    assert names[:L] == ["kv_mismatch_l0"] + [
        f"kv_share_l{i}" for i in range(1, L)]
    assert names[L:] and set(names[L:]) <= {"logit_gap_max", "logit_gap_mean"}
    assert all(v >= 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    # every metric a cell lists moves an end-to-end metric the cell has
    e2e = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_equals_registered_config(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    # no width is cut: only olmoe's expert capacity departs from its source
    assert set(conf["reduced"]) <= {"capacity_factor"}
    cfg = get_config(conf["port_config"])
    for key, value in conf["model"].items():
        assert getattr(cfg, key) == value, key
    assert conf["hdp"] == dataclasses.asdict(cfg.hdp)
    assert port_config(conf) is not None


def test_a_differing_shape_is_refused():
    entry = BENCH["configs"][0]
    conf = json.loads((ROOT / entry["file"]).read_text())
    conf["model"]["d_ff"] += 1
    with pytest.raises(ValueError, match="differ"):
        port_config(conf)
