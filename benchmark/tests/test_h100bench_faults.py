"""A run whose timed path is broken underneath comes out not correct:
the harness drives the whole run (its look for a card skipped) on a
tiny-width cell with the turbo cell's limits, once for each fault the
cell can have, and on the card at the turbo cell's own widths. (One
card: no exchange between cards to leave out.)"""

import pytest
import torch

from h100bench import spec
from h100bench.harness import run_cell
from tiny import tiny_cell



def _step_keeps_its_state(monkeypatch):
    """Each decode step hands back the cache it was given, unwritten."""
    import whisperjav_tpu_torch.models.whisper.decode as dec
    inner = dec.decode_step

    def step(model, tokens, pos, cache, cross):
        k, v = cache.k.clone(), cache.v.clone()
        logits, out = inner(model, tokens, pos, cache, cross)
        out.k.copy_(k)
        out.v.copy_(v)
        return logits, out
    monkeypatch.setattr(dec, "decode_step", step)


def _half_the_batch(monkeypatch):
    """The encoder computes the first half of the rows; the rest get
    their mean."""
    import whisperjav_tpu_torch.pipelines.engine as eng
    inner = eng.encode

    def encode(model, mel):
        half = mel.shape[0] // 2
        xa = inner(model, mel[:half])
        rest = xa.mean(0, keepdim=True).expand(mel.shape[0] - half, -1, -1)
        return torch.cat([xa, rest])
    monkeypatch.setattr(eng, "encode", encode)


def _token_altered(monkeypatch):
    """One served token of every row changed where the decode makes it."""
    import whisperjav_tpu_torch.pipelines.engine as eng
    inner = eng.decode_beam

    def decode_beam(*a, **k):
        res = inner(*a, **k)
        tok = res.tokens.clone()
        mid = tok.shape[1] // 2
        tok[:, mid] = (tok[:, mid] + 1) % 50000
        return res._replace(tokens=tok)
    monkeypatch.setattr(eng, "decode_beam", decode_beam)


FAULTS = [_step_keeps_its_state, _half_the_batch, _token_altered]


def _not_correct(cell, device):
    out = run_cell(cell, 2 ** 31 + 5, 0.0, False, device=device)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _not_correct(tiny_cell(), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct_on_the_card(fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch)
    _not_correct(spec.workload("turbo-balanced-packed"), "cuda")


@pytest.mark.parametrize("int8_weights", [False, True])
def test_sound_run_is_correct(int8_weights):
    out = run_cell(tiny_cell(int8_weights), 2 ** 31 + 5, 0.0, False,
                   device="cpu")
    assert out["correct"] is True, out["checks"]
