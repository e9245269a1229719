"""On the card, at each cell's own size: one short run of the cell reads
correct, the control (the reference one precision below the
configuration's in the program's place) fails the cell's comparison, and
a run with a fault planted in the timed path reads not correct: the
decode's K/V never written (a step that leaves its state unchanged), and
a token altered inside the graphed decode step (its K/V then written as
consistently as a right one's).
``python -m pytest -m card servebench/tests`` on a machine with a card;
``python -m servebench.calibrate`` reads the same numbers over many
seeds."""
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(autouse=True)
def _free_the_card():
    """Each test's engine and weights gone before the next builds its
    own: one cell's state and another's do not fit the card together."""
    yield
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _cell(work):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from servebench import run
    run.prepare_env()
    return run.Cell.load(work)


@pytest.mark.card
@pytest.mark.parametrize("work", WORKLOADS)
def test_cell_correct_and_control_fails(work):
    cell = _cell(work)
    from servebench import check, run
    out = run.measure(cell, 2 ** 31 + 17, 10.0, False, keep_weights=True)
    W, got = out.pop("_weights"), out.pop("_checked")
    assert out["correct"], out["checks"]
    ctl = check.control_numbers(W, cell.conf, got["seqs"], got, "cuda")
    assert any(ctl[k] > lim for k, lim in cell.limits.items())


def _token_altered_in_step(orig):
    """The decode step's argmax moved to the next token id, as a finite
    logit: the step then writes that token's K/V as it would a right one."""
    def decode(cfg, params, token, cache, pos, **kw):
        logits, *rest = orig(cfg, params, token, cache, pos, **kw)
        alt = (logits.argmax(-1, keepdim=True) + 1) % logits.shape[-1]
        top = logits.amax(-1, keepdim=True)
        return (logits.scatter(-1, alt, top + 1.0), *rest)
    return decode


@pytest.mark.card
@pytest.mark.parametrize("work", WORKLOADS)
@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered_in_step"])
def test_a_broken_path_is_not_correct_on_the_card(work, fault, monkeypatch):
    cell = _cell(work)
    import repro_torch.models.attention as attention
    from repro_torch.models import registry
    from servebench import run
    if fault == "state_unchanged":
        monkeypatch.setattr(attention, "_paged_write", lambda *a, **k: None)
    else:
        monkeypatch.setattr(registry, "apply_decode",
                            _token_altered_in_step(registry.apply_decode))
    out = run.measure(cell, 2 ** 31 + 29, 10.0, False)
    assert not out["correct"], out["checks"]
    print(work, fault, {k: c["value"] for k, c in out["checks"].items()
                        if c["value"] > c["limit"]})
