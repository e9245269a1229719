"""The traffic generator: the same seed gives the same requests, other
seeds other tokens over the same sizes, every size within its file's
bounds and the configuration's max_len."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import traffic as T

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def spec(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def stream(s, seed, n_clients=4, n=30):
    tr = T.Traffic(s, 1000, seed)
    clients = [T.Client(tr, i) for i in range(n_clients)]
    return [clients[i % n_clients].next() for i in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a, b = stream(spec(mix), 2 ** 40 + 3), stream(spec(mix), 2 ** 40 + 3)
    assert [(t.session, t.turn, t.max_new) for t in a] == \
        [(t.session, t.turn, t.max_new) for t in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_tokens_same_sizes(mix):
    s = spec(mix)
    t1, t2 = T.Traffic(s, 1000, 11), T.Traffic(s, 1000, 12)
    n = s["pool"]
    one = [t1.session(k) for k in range(n)]
    two = [t2.session(k) for k in range(n)]
    assert any(not np.array_equal(x[0].prompt, y[0].prompt)
               for x, y in zip(one, two))

    def sizes(sessions):
        return Counter(tuple((len(t.prompt), t.max_new) for t in ss)
                       for ss in sessions)

    assert sizes(one) == sizes(two)      # one whole pool: the same multiset


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_within_bounds(mix):
    s = spec(mix)
    pre = s.get("shared_len")
    for sz in T.size_pool(s):
        if pre:
            assert pre["min"] <= sz.prefix <= pre["max"]
        else:
            assert sz.prefix == 0
        assert all(s["prompt_len"]["min"] <= p <= s["prompt_len"]["max"]
                   for p in sz.prompts)
        assert all(s["answer_len"]["min"] <= a <= s["answer_len"]["max"]
                   for a in sz.answers)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["traffic"] != mix:
            continue
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        conf = json.loads((HERE.parent / entry["file"]).read_text())
        assert T.longest_request(s) <= conf["engine"]["max_len"]


def test_sessions_share_their_prefix_and_stagger():
    s = spec("docqa")
    tr = T.Traffic(s, 50304, 5)
    turns = tr.session(0)
    assert len(turns) == s["turns"]
    pre = T.size_pool(s)[tr._order[0]].prefix
    assert all(np.array_equal(t.prompt[:pre], turns[0].prompt[:pre])
               for t in turns)
    firsts = [T.Client(T.Traffic(s, 50304, 5), i).next().turn
              for i in range(s["turns"])]
    assert firsts == list(range(s["turns"]))


def test_draw_len():
    rng = np.random.default_rng(0)
    u = [T.draw_len({"dist": "uniform", "min": 3, "max": 5}, rng)
         for _ in range(200)]
    assert set(u) == {3, 4, 5}
    ln = [T.draw_len({"dist": "lognormal", "median": 100, "sigma": 0.5,
                      "min": 40, "max": 300}, rng) for _ in range(2000)]
    assert min(ln) >= 40 and max(ln) <= 300
    assert 90 <= np.median(ln) <= 110
    assert T.draw_len(None, rng) == 0
