"""A configuration served through another entry point than Whisper's
engine is added by new files alone: in a copy of the benchmark, a toy
driver (``data/toy/driver.py``), its configuration, traffic and cells,
and their entries in a copy of BENCHMARK.json, run to the last line
(``run.main`` on the CPU), and no file that was there changes. A number
that a cell's limits name and its driver does not read makes the run
not correct. Whisper's driver counts the model's operations as
``roofline/model_flops`` does."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import harness, spec
from roofline import model_flops
from tiny import tiny_cell

BENCH = Path(__file__).resolve().parents[1]
TOY = BENCH / "tests" / "data" / "toy"
# each toy file and where a later change would add it
NEW = {"driver.py": "drivers/toy.py", "config.json": "configs/toy-matmul.json",
       "traffic.json": "traffic/toy-rows.json",
       "cell.json": "workloads/toy-matmul.rows.json",
       "cell-unread.json": "workloads/toy-matmul.unread.json"}
RUN = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
       "sys.exit(run.main(sys.argv[1:], device='cpu'))")


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout: the benchmark and BENCHMARK.json copied, the port
    beside them, then the toy's files added; with the digests of every
    file that was there before."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "whisperjav_tpu_torch").symlink_to(
        BENCH.parent / "whisperjav_tpu_torch")
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    before = _digests(root / "benchmark")
    for src, dst in NEW.items():
        assert not (root / "benchmark" / dst).exists(), dst
        shutil.copy(TOY / src, root / "benchmark" / dst)
    cfg = json.loads((TOY / "config.json").read_text())
    bench["configs"].append({
        "name": cfg["name"], "source": "https://example.org/toy",
        "file": "benchmark/configs/toy-matmul.json", "reduced": [],
        "why": "a toy layer"})
    for name in ("cell.json", "cell-unread.json"):
        cell = json.loads((TOY / name).read_text())
        bench["workloads"].append({k: cell[k] for k in (
            "name", "config", "traffic", "chips", "why")})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root, before


def _run(root: Path, cell: str, trace: int):
    out = subprocess.run(
        [sys.executable, "-c", RUN, "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "0.3", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_driver_runs_by_new_files_only(checkout, trace):
    root, before = checkout
    rc, out, err = _run(root, "toy-matmul.rows", trace)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 32 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["max_err"]["value"] <= 1e-4
    if trace:
        # step_mfu reads what the driver counted; Whisper's readers
        # find nothing to read
        assert "step_mfu" in line["metrics"]
        assert not {"decode.step_ms", "encoder.ms_per_window",
                    "encoder_attention_roofline"} & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"audio_rtf", "peak_mem_gib",
                                        "setup_s"}
    lines = err.strip().splitlines()
    assert lines[-1].startswith("check max_err: ")
    assert lines[-2].startswith("reading mean_err: ")
    after = _digests(root / "benchmark")
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {Path(p) for p in NEW.values()}


def test_a_limit_on_a_number_not_read_is_not_correct(checkout):
    root, _ = checkout
    rc, out, err = _run(root, "toy-matmul.unread", 0)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["unread"] == {"value": None, "limit": 1.0}
    assert line["checks"]["max_err"]["value"] <= 1e-4
    assert "check unread: not read (limit 1.0)" in err.splitlines()


class _Keep:
    UNIT = ""
    stretch = None

    @classmethod
    def read(cls, stretch):
        cls.stretch = stretch


def test_whisper_counts_the_model_flops():
    out = harness.run_cell(tiny_cell(), 2 ** 31 + 13, 0.0, True,
                           device="cpu", per_layer={"_keep": _Keep})
    stretch, cell = _Keep.stretch, tiny_cell()
    beams = cell["config"]["decode_options"]["beam_size"]
    prompt_len = stretch.decode["prompt_len"]
    assert stretch.batches and stretch.decode["beams"] == beams
    assert stretch.model_flops == sum(
        model_flops.batch(cell["config"]["model"], b["bucket"], b["rows"],
                          beams, b["steps"], prompt_len)
        for b in stretch.batches)
    assert stretch.rows == sum(b["rows"] for b in stretch.batches) \
        == out["attempted"]
    assert spec.metric("step_mfu").read(stretch) > 0
