"""The port's file-level tools against the JAX package's on the CPU:
``e2e_bench``'s synthetic WAV (byte-identical) and its JSON line (the
JAX tool's keys, ``batch_phase_s`` under ``WJAV_TRACE_BATCHES=1``), the
engine's per-batch trace (the same rows as the JAX engine's), and
``determinism_suite`` (equal hashes run to run, the JAX summary).

The pipelines are built from one seeded JAX init at tiny widths (d=64,
2 + 2 layers, the real vocabulary), f32 on the CPU; the e2e run and one
determinism run use the port's real ``--model tiny`` instead."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ensemble import tiny_builders
from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu.pipelines.transcribe import (
    TranscribePipeline as JPipeline,
)
from whisperjav_tpu.tools import determinism_suite as jdet
from whisperjav_tpu.tools import e2e_bench as je2e
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines.transcribe import (
    TranscribePipeline as TPipeline,
)
from whisperjav_tpu_torch.tools import determinism_suite as tdet
from whisperjav_tpu_torch.tools import e2e_bench as te2e

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
_DIMS = dict(name="trace-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
TINY, TTINY = WhisperConfig(**_DIMS), TWhisperConfig(**_DIMS)
# the JSON line of the JAX tool's CLI path (whisperjav_tpu/tools/
# e2e_bench.py main) with WJAV_TRACE_BATCHES set
JAX_E2E_KEYS = {"metric", "value", "unit", "vs_baseline", "audio_s",
                "wall_s", "process_wall_s", "process_rtf_x", "stage_s",
                "subtitles", "windows", "env", "batch_phase_s",
                "batch_s_each", "rungs_each"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("minutes,seed", [(0.25, 0), (0.5, 3), (1 / 3, 7)])
def test_synth_long_wav_is_the_jax_one(tmp_path, minutes, seed):
    a, b = tmp_path / "j.wav", tmp_path / "t.wav"
    assert te2e.synth_long_wav(b, minutes, seed) \
        == je2e.synth_long_wav(a, minutes, seed)
    assert b.read_bytes() == a.read_bytes()


def test_e2e_bench_cli_line(tmp_path):
    """One real run: the port's CLI as the child on the CPU (``--model
    tiny``, 0.5 min), with the batch trace on."""
    # two threads for the CLI child: the suite runs beside it
    env = dict(os.environ, WJAV_TRACE_BATCHES="1", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "whisperjav_tpu_torch.tools.e2e_bench",
         "--minutes", "0.5", "--model", "tiny", "--batch-size", "4",
         "--device", "cpu", "--budget-s", "500", "--stall-s", "200",
         "--", "--logprob-threshold", "-100"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert JAX_E2E_KEYS <= set(line)
    assert line["metric"] == "e2e_file_rtf_balanced" and line["value"] > 0
    assert line["device"] == "cpu"
    assert line["env"] == {"WJAV_TRACE_BATCHES": "1"}
    assert set(line["batch_phase_s"]) == set(te2e.BATCH_PHASES)
    assert len(line["rungs_each"]) == len(line["batch_s_each"]) >= 1
    assert line["audio_s"] == 30.0 and line["windows"] >= 1


def test_e2e_bench_refuses_a_missing_card(tmp_path):
    """The default device is cuda: on a host without a card the child
    exits with the port's error and the tool reports the failure."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, "-m", "whisperjav_tpu_torch.tools.e2e_bench",
         "--minutes", "0.1", "--model", "tiny"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3
    assert "no CUDA GPU" in proc.stderr and proc.stdout == ""


# ---------------------------------------------------------------------------
# the engine's batch trace
# ---------------------------------------------------------------------------

def _bursts():
    """Three speech-like bursts split by long silences (three scenes)."""
    rng = np.random.default_rng(0)
    parts = []
    for i, seconds in enumerate((5.0, 4.0, 6.0)):
        t = np.arange(int(seconds * SR)) / SR
        tone = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) \
            * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
        parts += [tone + 0.05 * rng.standard_normal(t.size),
                  np.zeros(6 * SR)]
    return np.concatenate(parts).astype(np.float32)


def _pipelines():
    params = init_params(TINY, jax.random.PRNGKey(4))
    kw = dict(max_new_tokens=24, cross_kv_int8=True)
    temps = (0.0, 0.2)          # one retry rung: its count is the same
    jeng = je.TranscriptionEngine(
        TINY, params, options=jd.DecodeOptions(**kw),
        thresholds=je.QualityThresholds(temperatures=temps),
        batch_size=1, mesh=None, compute_dtype=jnp.float32)
    teng = te.TranscriptionEngine(
        TTINY, params_from_jax(jax.tree.map(np.asarray, params), TTINY),
        options=td.DecodeOptions(**kw),
        thresholds=te.QualityThresholds(temperatures=temps),
        batch_size=1, device="cpu", compute_dtype=torch.float32)
    return (JPipeline(jeng, pack=False), TPipeline(teng, pack=False))


def test_batch_trace_matches_jax(monkeypatch):
    jpipe, tpipe = _pipelines()
    audio = _bursts()
    monkeypatch.delenv("WJAV_TRACE_BATCHES", raising=False)
    assert "batch_trace" not in jpipe.process_audio(audio, SR)[1]
    assert "batch_trace" not in tpipe.process_audio(audio, SR)[1]

    monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    jtrace = jpipe.process_audio(audio, SR)[1]["batch_trace"]
    ttrace = tpipe.process_audio(audio, SR)[1]["batch_trace"]
    assert len(ttrace) == len(jtrace) >= 3
    for got, want in zip(ttrace, jtrace):
        for key in ("rungs", "retry_rows", "audio_s"):
            assert got.get(key) == want.get(key), (got, want)
    batch_rows = [r for r in ttrace if "retry_rows" not in r]
    for row in batch_rows:
        assert set(row) == {"encode_s", "decode_s", "ladder_s",
                            "extract_s", "batch_s", "audio_s", "rungs",
                            "bucket", "rows"}
        assert row["batch_s"] >= row["encode_s"] + row["decode_s"] - 1e-3
    retry = [r for r in ttrace if "retry_rows" in r]
    assert len(retry) == 1 and retry[0]["rungs"] == 2
    assert set(retry[0]) == {"retry_rows", "rungs", "ladder_s", "batch_s"}


# ---------------------------------------------------------------------------
# determinism_suite
# ---------------------------------------------------------------------------

def _clip(path, seconds=6.0):
    rng = np.random.default_rng(1)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 4 * t)) + 0.05 * rng.standard_normal(t.size)
    gap = np.zeros(SR, np.float32)
    write_wav(path, np.concatenate([gap, x.astype(np.float32), gap]), SR)
    return path


def _suite(main, media, root, extra):
    # seeded weights may leave no cue after the gates and the sanitizer:
    # the floor is 0, so the verdict is the hashes'
    rc = main(["--media", str(media), "--runs", "2", "--batch-size", "2",
               "--catastrophic-floor", "0", "--output-root", str(root),
               *extra])
    runs = [json.loads(ln) for ln in
            (root / "results.jsonl").read_text().splitlines()]
    return rc, json.loads((root / "summary.json").read_text()), runs


@pytest.mark.parametrize("ensemble", [False, True],
                         ids=["single", "ensemble"])
def test_determinism_suite_matches_jax(tmp_path, monkeypatch, ensemble):
    """On both packages' tiny f32 pipelines: two runs give one hash, the
    same hash as the JAX suite's, and the same summary."""
    tiny_builders(monkeypatch)
    media = _clip(tmp_path / "clip.wav")
    extra = ["--ensemble"] if ensemble else ["--mode", "balanced"]
    jrc, jsum, jruns = _suite(jdet.main, media, tmp_path / "j", extra)
    trc, tsum, truns = _suite(tdet.main, media, tmp_path / "t",
                              extra + ["--device", "cpu"])
    assert trc == jrc == 0
    assert tsum == jsum and tsum["deterministic"] and \
        tsum["verdict"] == "PASS"
    assert [r["srt_sha"] for r in truns] == [r["srt_sha"] for r in jruns]
    assert [set(r) for r in truns] == [set(r) for r in jruns]
    assert tdet.summarize(jruns, 1) == jdet.summarize(jruns, 1)


def test_determinism_suite_real_tiny(tmp_path, monkeypatch):
    """The port's own build path (``--model tiny``, seeded init, bf16 on
    the CPU; one rung, to keep it short): two runs, one hash."""
    from whisperjav_tpu_torch.pipelines import factory
    monkeypatch.setattr(factory, "ladder", lambda temps: (0.0,))
    media = _clip(tmp_path / "clip.wav", 3.0)
    rc, summary, runs = _suite(
        tdet.main, media, tmp_path / "t",
        ["--model", "tiny", "--mode", "fast", "--device", "cpu"])
    assert rc == 0 and summary["distinct_outputs"] == 1
    assert len({r["srt_sha"] for r in runs}) == 1 and runs[0]["cues"] >= 0
