"""The engine's prefill work worked out again (``reference/replay.py``)
against the engine's own counters, and the prefix model's pages."""
import numpy as np
import pytest
import torch

from servebench.reference.replay import (PrefixModel, prefill_calls,
                                         shared_spans, tail_len)

torch.set_num_threads(1)
B = (256, 512, 1024, 2048)


@pytest.mark.parametrize("plen,hit,want", [
    (100, 0, [(0, 256)]), (256, 0, [(0, 256)]), (257, 0, [(0, 512)]),
    (2048, 0, [(0, 2048)]), (3000, 0, [(0, 2048), (2048, 1024)]),
    (3136, 0, [(0, 2048), (2048, 2048)]), (1600, 1536, [(1536, 256)]),
    (3100, 2944, [(2944, 256)]), (4000, 0, [(0, 2048), (2048, 2048)]),
    (1536, 1536, [])])
def test_prefill_calls(plen, hit, want):
    prompt = np.arange(plen) + 7
    calls = prefill_calls(prompt, hit, B, 4096)
    assert [(off, len(t)) for off, t in calls] == want
    for off, t in calls:
        real = min(plen - off, len(t))
        assert np.array_equal(t[:real], prompt[off:off + real])
        assert (t[real:] == prompt[-1]).all()


def test_tail_len_respects_max_len():
    assert tail_len(100, 4000, B, 4096) == 100
    assert tail_len(100, 3000, B, 4096) == 256


def test_prefix_model_first_owner_wins():
    m = PrefixModel(4)
    doc = np.arange(10)
    a = np.concatenate([doc, [50, 51, 52]])          # 13 tokens: 3 pages
    b = np.concatenate([doc, [60, 61, 62, 63, 64]])  # 15: 3 pages
    assert m.match(a) == []
    m.register(1, a)
    assert m.match(b) == [1, 1]                      # tokens 0-7 shared
    m.register(2, b)
    c = np.concatenate([doc[:8], [0] * 9])
    assert m.match(c) == [1, 1]
    d = np.concatenate([doc, [60, 61, 62, 63, 64, 65]])
    assert m.match(d) == [1, 1, 2]
    assert shared_spans([1, 1, 2], 4) == [(0, 8, 1), (8, 12, 2)]
    assert shared_spans([], 4) == []
