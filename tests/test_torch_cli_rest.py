"""The rest of the port's command line on the CPU: ``--async-processing``
(the same SRTs as the file loop; each written SRT finalised, where the
JAX CLI finalises none), ``--trace-params`` (the JAX package's events),
``--check`` (with the card and ``nvcc`` faked present and absent), the
progress manager, and two repairs: the enhancers' default device and the
kernel library's thread-safe first load.

The CLI runs use both packages' ``build_pipeline`` patched to one tiny
f32 pipeline on shared weights (``test_torch_ensemble.tiny_builders``),
so SRTs compare byte for byte; trace events compare with their wall
times taken out."""

import io
import json
import threading
from pathlib import Path

import pytest
import torch

from test_torch_ensemble import short_wavs, tiny_builders
from whisperjav_tpu import cli as jcli
from whisperjav_tpu.modules.srt import load_srt
from whisperjav_tpu_torch import cli as tcli
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

_RUN = ["--no-sanitize", "--batch-size", "2"]
# wall-clock fields of the pipeline's stats
_WALLS = {"stage_s", "segmentation_s", "asr_s", "rtf_x", "e2e_wall_s",
          "e2e_rtf_x"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cues(path):
    """(start, end, text) of every cue but the technical signature."""
    return [(s.start, s.end, s.text) for s in load_srt(path)
            if not s.text.startswith("WhisperJAV-TPU")]


def test_async_writes_the_file_loops_srts(tmp_path, monkeypatch):
    """Two clips through ``--async-processing`` give the file loop's
    SRTs byte for byte, signatures included, each with its VTT under
    ``--output-format both``."""
    tiny_builders(monkeypatch)
    wavs = [str(w) for w in short_wavs(tmp_path, 2)]
    assert tcli.main([*wavs, "--output-dir", str(tmp_path / "sync"),
                      *_RUN]) == 0
    assert tcli.main([*wavs, "--output-dir", str(tmp_path / "async"),
                      "--async-processing", "--output-format", "both",
                      "--stats-file", str(tmp_path / "s.json"), *_RUN]) == 0
    for i in range(2):
        name = f"clip{i}.ja.whisperjav.srt"
        got = (tmp_path / "async" / name).read_bytes()
        assert got == (tmp_path / "sync" / name).read_bytes()
        assert b"WhisperJAV-TPU" in got
        assert (tmp_path / "async" / name).with_suffix(".vtt").exists()
    summary = json.loads((tmp_path / "s.json").read_text())
    assert summary["failures"] == 0 and len(summary["results"]) == 2


def test_async_finalises_where_the_jax_cli_does_not(tmp_path, monkeypatch):
    """On one clip with ``--async-processing --output-format both`` the
    JAX CLI writes an unsigned SRT and no VTT (it reads a ``srt_path``
    attribute the written ``Path`` does not have); the port signs it and
    writes the VTT. The cues are the same."""
    tiny_builders(monkeypatch)
    wav = str(short_wavs(tmp_path, 1)[0])
    out = {}
    for side, mod in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / side
        assert mod.main([wav, "--output-dir", str(d), "--async-processing",
                         "--output-format", "both", *_RUN]) == 0
        srt = d / "clip0.ja.whisperjav.srt"
        out[side] = (srt.read_text(encoding="utf-8"),
                     srt.with_suffix(".vtt").exists(), _cues(srt))
    assert "WhisperJAV-TPU" not in out["jax"][0] and not out["jax"][1]
    assert "WhisperJAV-TPU" in out["torch"][0] and out["torch"][1]
    assert out["torch"][2] == out["jax"][2] and len(out["torch"][2]) >= 1


def test_async_cancel_writes_nothing_more(tmp_path, monkeypatch):
    """Cancelling after the first file: it is written in full, the others
    are marked cancelled and write nothing."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.pipelines import factory
    from whisperjav_tpu_torch.utils.async_processor import (
        AsyncPipelineManager,
    )
    tiny_builders(monkeypatch)
    wavs = short_wavs(tmp_path, 3)
    mgr = AsyncPipelineManager(factory.build_pipeline(
        resolve_pipeline_config(batch_size=2)), max_prefetch=1)
    outcomes = mgr.process_files([probe(w) for w in wavs], tmp_path / "o",
                                 on_complete=lambda m, r: mgr.cancel())
    assert [o.ok for o in outcomes][0] and not any(
        o.ok for o in outcomes[1:])
    assert {o.error for o in outcomes[1:]} == {"cancelled"}
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == \
        ["clip0.ja.whisperjav.srt"]
    load_srt(tmp_path / "o" / "clip0.ja.whisperjav.srt")


def _events(path):
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in _WALLS}
        return x
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(set(r) == {"t", "ts", "event", "data"} for r in recs)
    return [(r["event"], strip(r["data"])) for r in recs]


def test_trace_params_events_match_jax(tmp_path, monkeypatch):
    """``--trace-params`` on two clips: the JAX package's events (config,
    then file_start, segmentation and file_complete per file) with the
    same data, ``t``/``ts`` and wall times aside; the port closes the
    file when the run ends."""
    tiny_builders(monkeypatch)
    wavs = [str(w) for w in short_wavs(tmp_path, 2)]
    out = {}
    for side, mod in (("jax", jcli), ("torch", tcli)):
        trace = tmp_path / f"{side}.jsonl"
        assert mod.main([*wavs, "--output-dir", str(tmp_path / side),
                         "--trace-params", str(trace), *_RUN]) == 0
        out[side] = _events(trace)
    assert out["torch"] == out["jax"]
    assert [e for e, _ in out["torch"]] == [
        "config"] + ["file_start", "segmentation", "file_complete"] * 2
    # the async path traces each file from the caller's thread (the JAX
    # manager writes only the config event)
    trace = tmp_path / "async.jsonl"
    assert tcli.main([*wavs, "--output-dir", str(tmp_path / "a"),
                      "--async-processing", "--trace-params", str(trace),
                      *_RUN]) == 0
    events = _events(trace)
    assert [e for e, _ in events] == [
        "config"] + ["file_start", "segmentation", "file_complete"] * 2
    assert events[2][1] == out["torch"][2][1]


class _FakeCuda:
    def __init__(self, n):
        self.n = n

    def is_available(self):
        return self.n > 0

    def device_count(self):
        return self.n

    def get_device_name(self, i=0):
        return "NVIDIA H100 80GB HBM3"

    def get_device_capability(self, i=0):
        return (9, 0)


@pytest.mark.parametrize("card", [True, False], ids=["card", "no-card"])
@pytest.mark.parametrize("flag", ["--check", "--check-verbose"])
def test_check_rows_and_return_code(monkeypatch, capsys, card, flag):
    """The JAX rows with torch in place of jax, the card's name and
    compute capability, and nvcc as a hard requirement: rc 0 with a card
    and nvcc, 1 without; no input file is needed."""
    from whisperjav_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(torch, "cuda", _FakeCuda(1 if card else 0))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    real_isfile = _build.os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: (
        card if str(p).endswith("/nvcc") else real_isfile(p)))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert tcli.main([flag]) == (0 if card else 1)
    rows = capsys.readouterr().out.splitlines()
    names = [r.split("]", 1)[1].split()[0] for r in rows]
    assert names == ["python", "numpy", "scipy", "torch", "accelerator",
                     "nvcc", "ffmpeg", "ffprobe", "transformers"]
    acc = rows[names.index("accelerator")]
    nvcc = rows[names.index("nvcc")]
    if card:
        assert acc.startswith("[OK ]") and "NVIDIA H100" in acc \
            and "sm_90" in acc
        assert nvcc.startswith("[OK ]")
    else:
        assert acc.startswith("[FAIL]") and nvcc.startswith("[FAIL]")


def test_progress_manager_matches_jax_and_is_silent_when_off(tmp_path,
                                                             monkeypatch,
                                                             capfd):
    """Drawn on a stream, the port's progress lines equal the JAX
    manager's (elapsed times aside); disabled, it writes nothing, and a
    ``--no-progress`` run draws no progress line."""
    import re
    from whisperjav_tpu.utils.progress import ProgressManager as J
    from whisperjav_tpu_torch.utils.progress import ProgressManager as T
    drawn = {}
    for side, cls in (("jax", J), ("torch", T)):
        buf = io.StringIO()
        pm = cls(enabled=True, min_interval_s=0.0, stream=buf)
        pm.task("files", 3)
        for _ in range(3):
            pm.advance("files")
        pm.finish("files")
        drawn[side] = re.sub(r"\d+\.\d+s", "<t>", buf.getvalue())
        quiet = io.StringIO()
        off = cls(enabled=False, stream=quiet)
        off.task("files", 2)
        off.advance("files")
        off.finish("files")
        assert quiet.getvalue() == ""
    assert drawn["torch"] == drawn["jax"] and "files 3/3" in drawn["torch"]
    tiny_builders(monkeypatch)
    wav = str(short_wavs(tmp_path, 1)[0])
    capfd.readouterr()
    assert tcli.main([wav, "--output-dir", str(tmp_path / "o"),
                      "--no-progress", *_RUN]) == 0
    assert "files 0/1" not in capfd.readouterr().err


def test_enhancers_default_to_cuda_and_build_without_a_card():
    """``create_enhancer`` and the network backends default to the card;
    with no weights they build on a host without one, and
    ``get_extraction_sample_rate`` only reads a rate."""
    from whisperjav_tpu_torch.modules.enhancement import (
        create_enhancer, get_extraction_sample_rate,
    )
    from whisperjav_tpu_torch.modules.enhancement.bandsplit_backends import (
        BsRoformerBackend, ClearVoiceBackend,
    )
    from whisperjav_tpu_torch.modules.enhancement.zipenhancer import (
        ZipEnhancer,
    )
    for backend in ("zipenhancer", "bs-roformer", "clearvoice"):
        enh = create_enhancer(backend)
        assert enh.device == torch.device("cuda")
        assert enh._model is None
    for cls in (ZipEnhancer, BsRoformerBackend, ClearVoiceBackend):
        assert cls().device == torch.device("cuda")
    assert create_enhancer("zip", device="cpu").device == \
        torch.device("cpu")
    assert [get_extraction_sample_rate(b) for b in
            ("none", "zipenhancer", "bs-roformer", "clearvoice")] == \
        [16_000, 16_000, 44_100, 48_000]


def test_load_library_builds_once_under_threads(monkeypatch):
    """Eight threads make the first ``load_library()`` call together: one
    build, one load, the same object for all."""
    import sys
    import time
    from whisperjav_tpu_torch.ops.cuda import _build
    calls = {"build": 0, "open": 0}
    lib = object()

    def build():
        calls["build"] += 1
        time.sleep(0.05)        # a slow first build
        return Path("libx.so"), 0.0, ""

    def open_library(path):
        calls["open"] += 1
        return lib

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "open_library", open_library)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = []
    try:
        start = threading.Barrier(8)

        def first_call():
            start.wait()
            got.append(_build.load_library())

        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert calls == {"build": 1, "open": 1}
    assert len(got) == 8 and all(x is lib for x in got)


def test_concurrent_builds_use_their_own_temporary_files(tmp_path,
                                                         monkeypatch):
    """Threads of one process that build at once (a fake nvcc that
    records its output paths) never share an object directory or a
    temporary library, and the library ends up in place."""
    import subprocess
    from whisperjav_tpu_torch.ops.cuda import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    outputs, lock = [], threading.Lock()
    gate = threading.Barrier(4)

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            with lock:
                outputs.append(out)
            out.write_bytes(b"obj")

        def communicate(self):
            return "", ""

        def poll(self):
            return 0

    def fake_run(cmd, **kw):
        gate.wait(timeout=10)       # every thread is mid-build
        out = Path(cmd[cmd.index("-o") + 1])
        with lock:
            outputs.append(out)
        out.write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _build.build(csrc, tmp_path / "build"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads) and len(results) == 4
    objs = [p for p in outputs if p.suffix == ".o"]
    libs = [p for p in outputs if p.suffix == ".tmp"]
    assert len(set(objs)) == 8 and len(set(libs)) == 4
    assert len({p.parent for p in objs}) == 4
    assert results[0][0].read_bytes() == b"lib"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        [results[0][0].name]


def test_an_edited_header_names_a_new_library(tmp_path):
    """The library's name hashes the ``*.cuh`` headers as well as the
    sources, and a header is not compiled on its own."""
    from whisperjav_tpu_torch.ops.cuda import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "g.cuh"\n')
    (csrc / "g.cuh").write_text("// g\n")
    before = _build.library_path(csrc, tmp_path / "build")
    (csrc / "g.cuh").write_text("// g, edited\n")
    assert _build.library_path(csrc, tmp_path / "build") != before
    assert [p.name for p in _build.sources(csrc)] == ["a.cu"]


def test_the_shared_memory_guard_lives_in_one_header():
    """Every kernel source with dynamic shared memory takes the
    per-device cudaFuncSetAttribute guard from ``smem_guard.cuh``, and
    none calls the attribute itself."""
    from whisperjav_tpu_torch.ops.cuda import _build
    srcs = _build.sources()
    assert len(srcs) == 4
    dynamic = [src for src in srcs
               if "extern __shared__" in src.read_text()]
    assert [src.name for src in dynamic] == [
        "decode_cross_attention.cu", "encoder_attention.cu",
        "fused_decode.cu"]
    for src in srcs:
        text = src.read_text()
        assert "cudaFuncSetAttribute(" not in text, src.name
        if src in dynamic:
            assert '#include "smem_guard.cuh"' in text, src.name
            assert "allow_smem(" in text, src.name
    assert "cudaGetDevice(" in (_build.CSRC_DIR / "smem_guard.cuh").read_text()
