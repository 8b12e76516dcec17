"""One tiny-width cell end to end on the CPU through the port's plain
paths: the run's last line, traced and not, and the check."""

import json

import pytest

from h100bench import spec

import run
from tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def tiny(monkeypatch):
    cell = tiny_cell()
    monkeypatch.setattr(spec, "workload", lambda name: cell)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny, trace, capsys):
    rc = run.main(["--workload", "tiny", "--seed", str(2 ** 31 + 77),
                   "--seconds", "0.5", "--trace", str(trace)], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == set(KEYS + ["checks"] + (["breakdown"] if trace
                                                  else []))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] == 8 * ((line["attempted"] // 8) or 1)
    assert line["failed"] == 0
    want = {"decode.step_ms", "step_mfu"} if trace else {
        "audio_rtf", "peak_mem_gib", "setup_s"}
    assert want <= set(line["metrics"])
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split(":")[0] for x in last] == [
        f"check {name}" for name in line["checks"]]


def test_no_card_no_result(tiny, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "tiny", "--seed", "1", "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and not out.strip()


def test_forbidden_modules_are_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "whisperjav_tpu_torch_x", sys)
    assert not run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == {"jax"}
