"""The check's controls come out not correct, through the same verdict
a run gives: the reference computed one precision below the
configuration (``workloads/<cell>.json``: ``control``), put in the
program's place on the rows a sound run served, and the program with
its own lower-precision paths switched on (``program_controls``), while
the sound run comes out correct. On the CPU at tiny widths; on the card
at each cell's own widths and batch (``calibrate.py`` reads the same
over a dozen seeds). The controls are the cell's driver's."""

import pytest

from h100bench import harness, spec
from tiny import tiny_cell

WHISPER = spec.driver("whisper")
SEED = 2 ** 31 + 41


def _reference_control_fails(cell, device):
    out = harness.run_cell(cell, SEED, 0.0, False, device=device,
                           reference_control=cell["control"])
    assert out["correct"] is True, out["checks"]
    assert out["control"]["correct"] is False, out["control"]["checks"]
    return out


def _program_control_fails(cell, path, device):
    out = harness.run_cell(cell, SEED, 0.0, False, device=device,
                           program_control=path)
    assert out["correct"] is False, out["checks"]
    return out


@pytest.mark.parametrize("int8_weights", [False, True])
def test_control_fails_tiny(int8_weights):
    cell = tiny_cell(int8_weights)
    if int8_weights:
        cell.update(control="int4_weights")
    _reference_control_fails(cell, "cpu")


@pytest.mark.parametrize("path", WHISPER.PROGRAM_CONTROLS)
def test_program_control_fails_tiny(path):
    _program_control_fails(tiny_cell(), path, "cpu")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", spec.names("workloads"))
def test_control_fails_on_the_card(name, card):
    _reference_control_fails(spec.workload(name), card)


@pytest.mark.cuda
@pytest.mark.parametrize("name,path", [
    (name, path) for name in spec.names("workloads")
    for path in spec.workload(name)["program_controls"]])
def test_program_control_fails_on_the_card(name, path, card):
    _program_control_fails(spec.workload(name), path, card)
