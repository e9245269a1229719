"""The whole run on the CPU at reduced shapes: the engine's pool codes at
every layer and its served tokens against the plain reference, the
control one precision below failing the comparison, and every fault a
serving cell can have turning ``correct`` false: a step that leaves its
state unchanged (the decode's K/V never written), half of the batch left
out (the second half of the slots decoding another slot's token), a
token altered where it is emitted, and a token altered inside the decode
step (its K/V then written as consistently as a right one's)."""
import pytest
import torch

import repro_torch.models.attention as attention
from repro_torch.models import registry
from repro_torch.serving.engine import Engine
from servebench import check
from servebench.run import measure

from tiny import tiny_cell

torch.set_num_threads(1)
SEED = 2 ** 33 + 5
CELLS = {
    "olmoe-bf16": ("olmoe-1b-7b", "bfloat16", 0, 1e-3, 0.05),
    "granite-bf16": ("granite-8b", "bfloat16", 0, 1e-3, 0.05),
    "granite-f32": ("granite-8b", "float32", 0, 1e-4, 1e-3),
}


def run(name, **kw):
    cell, cfg = tiny_cell(*CELLS[name])
    return cell, measure(cell, SEED, 2.0, False, device="cpu", cfg=cfg, **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_program_against_reference_and_control(name):
    cell, out = run(name, keep_weights=True)
    W, got = out.pop("_weights"), out.pop("_checked")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 10 and out["failed"] == 0
    assert list(out["checks"])[-1] == "short_answers"
    assert got["tokens"] >= 20
    ctl = check.control_numbers(W, cell.conf, got["seqs"], got, "cpu")
    assert ctl["kv_mismatch_l0"] > cell.limits["kv_mismatch_l0"]
    assert ctl["logit_gap_max"] > cell.limits["logit_gap_max"]


def _emit_altered(orig, vocab):
    def emit(self, slot, tok, t_sync):
        if len(self._active[slot]["generated"]) == 1:
            tok = (tok + 1) % vocab
        return orig(self, slot, tok, t_sync)
    return emit


def _half_batch(orig):
    def decode(cfg, params, token, cache, pos, **kw):
        token = token.clone()
        token[token.shape[0] // 2:] = token[0]
        return orig(cfg, params, token, cache, pos, **kw)
    return decode


def _token_altered_in_step(orig):
    """The decode step's argmax moved to the next token id, as a finite
    logit: the step then writes that token's K/V as it would a right one."""
    def decode(cfg, params, token, cache, pos, **kw):
        logits, *rest = orig(cfg, params, token, cache, pos, **kw)
        alt = (logits.argmax(-1, keepdim=True) + 1) % logits.shape[-1]
        top = logits.amax(-1, keepdim=True)
        return (logits.scatter(-1, alt, top + 1.0), *rest)
    return decode


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered", "token_altered_in_step"])
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(attention, "_paged_write",
                            lambda *a, **k: None)
    elif fault == "half_batch":
        monkeypatch.setattr(registry, "apply_decode",
                            _half_batch(registry.apply_decode))
    elif fault == "token_altered_in_step":
        monkeypatch.setattr(registry, "apply_decode",
                            _token_altered_in_step(registry.apply_decode))
    else:
        monkeypatch.setattr(Engine, "_emit",
                            _emit_altered(Engine._emit, 256))
    _, out = run(name)
    assert not out["correct"], out["checks"]
