"""The port's web GUI (``whisperjav_tpu_torch/gui/server.py``,
``whisperjav-torch-gui``) against the JAX package's: the CLI argv of
every option set (equal up to the module name), the schemas, the HTTP
API over a port-0 server, the job queue driven by fake CLI children, the
trace tailer, the result regex and its ``--daemon`` departure, and one
job through the real port CLI on the CPU.

Queue tests wait on events (a spawned child, the queue's worker thread
ending), never on a wall clock; each wait has a generous limit as a
guard only."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import whisperjav_tpu.gui.server as jsrv
import whisperjav_tpu_torch.gui.server as psrv
from whisperjav_tpu.config.user_config import UserConfigManager as JConfig
from whisperjav_tpu_torch.modules.audio_io import write_wav
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

GUARD_S = 300   # limit of every wait (a guard: the waits are on events)


# ----------------------------------------------------------------- argv

OPTION_SETS = {
    "basics": {"inputs": ["/a.wav", "/b.wav"], "mode": "balanced",
               "sensitivity": "aggressive", "output_dir": "/out",
               "batch_size": 16, "make_vtt": True},
    "every-simple-flag": {
        "inputs": "/x.wav", "mode": "fidelity", "sensitivity":
        "conservative", "model": "large-v2", "checkpoint": "/m",
        "language": "ja", "subs_language": "english-direct",
        "output_dir": "/o", "batch_size": 8, "vad_backend": "ten",
        "scene_backend": "semantic", "enhancer": "zipenhancer",
        "translate": "identity", "translate_target": "english",
        "output_format": "both", "credit": "me", "beam_size": 3,
        "vad_threshold": 0.3, "speech_pad_ms": 200, "prompt": "字幕",
        "timestamp_mode": "aligner", "regroup_mode": "standard",
        "framer": "vad", "devices": 1, "task": "transcribe"},
    "every-bool-flag": {
        "inputs": "/x.wav", "skip_existing": True, "make_vtt": True,
        "no_sanitize": True, "keep_temp": True, "enhance_for_vad": True,
        "no_signature": True, "word_timestamps": True,
        "int8_weights": True, "no_vad": True},
    "false-bools": {"inputs": "/x.wav", "skip_existing": False,
                    "make_vtt": False, "word_timestamps": False},
    "component-dicts": {
        "inputs": "/x.wav",
        "vad_args": {"min_silence_duration_ms": 200, "use_pallas": True,
                     "off": False},
        "scene_args": {"max_scene_s": 20.5},
        "enhancer_args": {"strength": 0.7},
        "overrides": {"sensitivity.beam_size": 3}},
    "empty-values": {"inputs": "/x.wav", "model": "", "checkpoint": None,
                     "batch_size": [], "vad_args": "not a dict"},
    "no-inputs": {"mode": "balanced"},
    "daemon-default": {"inputs": "/x.wav", "mode": "balanced"},
    "daemon-false": {"inputs": "/x.wav", "mode": "balanced",
                     "daemon": False},
    "daemon-true": {"inputs": "/x.wav", "mode": "fast", "daemon": True},
    "daemon-none": {"inputs": "/x.wav", "daemon": None},
    "ensemble": {"inputs": "/x.wav", "ensemble": True},
    "ensemble-daemon": {"inputs": "/x.wav", "ensemble": True,
                        "daemon": True},
    "qwen": {"inputs": "/x.wav", "mode": "qwen"},
    "ensemble-passes": {
        "inputs": "/x.wav", "ensemble": True, "pass1_model": "turbo",
        "pass2_model": "large-v2", "pass1_sensitivity": "aggressive",
        "pass2_sensitivity": "conservative",
        "merge_strategy": "smart_merge"},
}


@pytest.mark.parametrize("options", list(OPTION_SETS.values()),
                         ids=list(OPTION_SETS))
def test_build_args_equal_up_to_the_module(options):
    want = jsrv.build_args(dict(options))
    got = psrv.build_args(dict(options))
    assert want[:3] == [sys.executable, "-m", "whisperjav_tpu.cli"]
    assert got[:3] == [sys.executable, "-m", "whisperjav_tpu_torch.cli"]
    assert got[3:] == want[3:]


def test_build_args_daemon_rules():
    has = lambda o: "--daemon" in psrv.build_args(o)   # noqa: E731
    assert has({"inputs": "/x.wav", "mode": "balanced"})
    assert not has({"inputs": "/x.wav", "daemon": False})
    assert has({"inputs": "/x.wav", "mode": "fast", "daemon": True})
    assert not has({"inputs": "/x.wav", "ensemble": True})
    assert not has({"inputs": "/x.wav", "mode": "qwen"})


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_build_args_device(device):
    """The port's one added option: ``device`` → ``--device``, which the
    JAX CLI does not have; without it the argv is the JAX one."""
    options = {"inputs": "/x.wav", "mode": "balanced", "device": device,
               "no_sanitize": True}
    got = psrv.build_args(dict(options))
    i = got.index("--device")
    assert got[i + 1] == device
    assert got[3:i] + got[i + 2:] == jsrv.build_args(dict(options))[3:]
    assert got[-1] == "--daemon"
    assert "--device" not in psrv.build_args({"inputs": "/x.wav",
                                              "device": ""})


# --------------------------------------------------------------- schemas

def test_schema_equal():
    got = psrv.schema()
    assert got == jsrv.schema()
    assert "tpu-local" in got["translate_providers"]
    assert got["component_types"] == ["enhancer", "sanitizer", "scene",
                                      "segmenter"]


COMPONENTS = [(t, n) for t, names in jsrv._COMPONENT_CONFIGS.items()
              for n in names]


@pytest.mark.parametrize("ctype,name", COMPONENTS,
                         ids=[f"{t}-{n}" for t, n in COMPONENTS])
def test_component_schema_equal(ctype, name):
    got = psrv.component_schema(ctype, name)
    assert got == jsrv.component_schema(ctype, name)
    assert got["success"] and got["fields"]
    module = psrv._COMPONENT_CONFIGS[ctype][name].split(":")[0]
    assert module.startswith("whisperjav_tpu_torch.modules.")


def test_component_registry_names_the_ports_modules():
    renamed = {"whisperjav_tpu.modules.segmentation.silero_jax":
               "whisperjav_tpu_torch.modules.segmentation.silero",
               "whisperjav_tpu.modules.segmentation.ten_jax":
               "whisperjav_tpu_torch.modules.segmentation.ten",
               "whisperjav_tpu.modules.enhancement.zip_jax":
               "whisperjav_tpu_torch.modules.enhancement.zipenhancer"}
    for ctype, names in jsrv._COMPONENT_CONFIGS.items():
        assert set(psrv._COMPONENT_CONFIGS[ctype]) == set(names)
        for name, spec in names.items():
            module = spec.split(":")[0]
            want = renamed.get(module, module.replace(
                "whisperjav_tpu.", "whisperjav_tpu_torch.", 1))
            assert psrv._COMPONENT_CONFIGS[ctype][name].split(":")[0] \
                == want
    assert psrv.component_schema("segmenter", "nope") == \
        jsrv.component_schema("segmenter", "nope")


# ------------------------------------------------------------------ HTTP

def _offline(timeout):
    raise urllib.error.URLError("offline")


@pytest.fixture
def gui(tmp_path, monkeypatch):
    """A port-0 GUI server with an offline release poll and a config
    directory of its own; yields its base URL and the server."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    server = psrv.make_server(fetch=_offline)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(GUARD_S)


def _get(url):
    with urllib.request.urlopen(url, timeout=GUARD_S) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=GUARD_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_endpoints(gui):
    base, _ = gui
    html = _get(f"{base}/").decode()
    assert html == _get(f"{base}/index.html").decode() == psrv.APP_HTML
    assert "WhisperJAV" in html and "loadVersion" in html
    assert json.loads(_get(f"{base}/api/schema")) == json.loads(
        json.dumps(jsrv.schema()))
    assert json.loads(_get(f"{base}/api/status")) == {"status": "idle"}
    assert json.loads(_get(f"{base}/api/queue")) == {"jobs": [],
                                                     "status": "idle"}
    assert json.loads(_get(f"{base}/api/logs")) == {
        "lines": [], "next": 0, "status": "idle"}
    out = json.loads(_get(f"{base}/api/component_schema"
                          "?type=enhancer&name=dsp"))
    assert out == json.loads(json.dumps(jsrv.component_schema(
        "enhancer", "dsp")))
    assert json.loads(_get(f"{base}/api/version")) == {
        "version": "0.1.0", "latest": None, "update_available": False,
        "checked": False}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{base}/nope")
    assert e.value.code == 404
    assert _post(f"{base}/api/start", {"inputs": []}) == (
        400, {"ok": False, "error": "no inputs"})
    assert _post(f"{base}/api/nope", {})[0] == 404


@pytest.mark.parametrize("tag,available", [("v99.0.0", True),
                                           ("v0.1.0", False)])
def test_http_version_uses_the_servers_fetch(tag, available):
    server = psrv.make_server(fetch=lambda timeout: {"tag_name": tag})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        got = json.loads(_get(
            f"http://127.0.0.1:{server.server_address[1]}/api/version"))
    finally:
        server.shutdown()
        server.server_close()
    assert got == {"version": "0.1.0", "latest": tag,
                   "update_available": available, "checked": True}


def test_http_presets_cross_read_with_the_jax_config(gui, tmp_path):
    """Presets saved over HTTP land in the JAX package's config file and
    path; one the JAX manager saves is listed by the port's GUI."""
    base, _ = gui
    opts = {"mode": "fidelity", "batch_size": "16", "ensemble": False}
    assert _post(f"{base}/api/presets", {"name": "夜", "options": opts}) \
        == (200, {"ok": True})
    assert JConfig().get_preset("夜") == opts
    JConfig().save_preset("from-jax", {"mode": "qwen"})
    assert json.loads(_get(f"{base}/api/presets")) == {
        "from-jax": {"mode": "qwen"}, "夜": opts}
    assert _post(f"{base}/api/presets", {"name": " ", "options": {}}) == (
        400, {"ok": False, "error": "preset name must be non-empty"})
    assert _post(f"{base}/api/presets", {"name": "夜", "delete": True}) \
        == (200, {"ok": True})
    assert _post(f"{base}/api/presets", {"name": "夜", "delete": True}) \
        == (200, {"ok": False})
    assert JConfig().list_presets() == ["from-jax"]
    assert (tmp_path / "xdg" / "whisperjav-tpu" / "config.json").exists()


def test_each_server_has_its_own_queue():
    a, b = psrv.make_server(), psrv.make_server()
    try:
        assert a.queue is not b.queue
        assert not hasattr(psrv, "JOB")
    finally:
        a.server_close()
        b.server_close()


# ----------------------------------------------------------------- queue

def _fake_cli(tmp_path, message="wrote /tmp/x.ja.whisperjav.srt "
                                "(3 subtitles, RTF 5.0x)"):
    """build_args stand-in: a child that records its start and end in a
    shared file, says 'processing', and prints ``message``."""
    order = tmp_path / "order.txt"

    def build(options):
        name = Path(options["inputs"][0]).name
        code = (f"import time; f = open({str(order)!r}, 'a'); "
                f"f.write('start {name}\\n'); f.flush(); "
                f"print('processing {name}', flush=True); time.sleep(0.2); "
                f"f.write('end {name}\\n'); f.close(); print({message!r})")
        return [sys.executable, "-u", "-c", code]
    return build, order


def _wavs(tmp_path, n):
    paths = []
    for i in range(n):
        p = tmp_path / f"in{i}.wav"
        p.write_bytes(b"RIFF")
        paths.append(str(p))
    return paths


def _drain(queue):
    """Wait for the queue's worker thread to end (no job left)."""
    queue._worker.join(GUARD_S)
    assert not queue._worker.is_alive()


def test_queue_runs_jobs_one_at_a_time(monkeypatch, tmp_path):
    build, order = _fake_cli(tmp_path)
    monkeypatch.setattr(psrv, "build_args", build)
    q = psrv._QueueState()
    wavs = _wavs(tmp_path, 3)
    assert q.enqueue(wavs, {"mode": "faster"}) == [0, 1, 2]
    _drain(q)
    assert q.status() == "done"
    jobs = q.summaries()
    assert [j["status"] for j in jobs] == ["done"] * 3
    assert [j["file"] for j in jobs] == wavs
    assert order.read_text().split("\n")[:-1] == [
        f"{e} in{i}.wav" for i in range(3) for e in ("start", "end")]
    for j in jobs:
        assert j["result"] == {"srt": "/tmp/x.ja.whisperjav.srt",
                               "subtitles": 3, "rtf_x": 5.0}
        assert j["stage"] == "" and j["stages"][:2] == ["starting",
                                                        "processing"]
        logs = q.job_logs(j["id"], 0)
        assert logs["lines"][0].startswith("$ ")
        assert any("processing" in ln for ln in logs["lines"])
        assert logs["lines"][-1] == "[exit 0]"
    assert q.job_logs(99, 0) == {"lines": [], "next": 0,
                                 "status": "unknown"}


def test_queue_one_job_per_discovered_file(monkeypatch, tmp_path):
    """A directory input becomes one job per media file in it."""
    build, _ = _fake_cli(tmp_path)
    monkeypatch.setattr(psrv, "build_args", build)
    media = tmp_path / "media"
    media.mkdir()
    for name in ("b.wav", "a.wav", "notes.txt"):
        write_wav(media / name, np.zeros(1600, np.float32), 16000) \
            if name.endswith(".wav") else (media / name).write_text("x")
    q = psrv._QueueState()
    assert q.enqueue([str(media)], {}) == [0, 1]
    _drain(q)
    assert [Path(j["file"]).name for j in q.summaries()] == ["a.wav",
                                                             "b.wav"]


def test_queue_failed_child(monkeypatch, tmp_path):
    monkeypatch.setattr(psrv, "build_args", lambda o: [
        sys.executable, "-c", "import sys; print('bad'); sys.exit(3)"])
    q = psrv._QueueState()
    q.enqueue(_wavs(tmp_path, 1), {})
    _drain(q)
    assert q.summaries()[0]["status"] == "failed"
    assert q.status() == "failed"
    assert q.job_logs(0, 0)["lines"][-1] == "[exit 3]"


def test_queue_http(monkeypatch, tmp_path, gui):
    """POST /api/start enqueues per-file jobs; /api/queue reports them;
    /api/logs serves a job's lines and defaults to the last job."""
    base, server = gui
    build, _ = _fake_cli(tmp_path)
    monkeypatch.setattr(psrv, "build_args", build)
    wavs = _wavs(tmp_path, 2)
    assert _post(f"{base}/api/start", {"inputs": wavs[0]}) == (
        200, {"ok": True, "jobs": [0]})
    _drain(server.queue)
    assert _post(f"{base}/api/start", {"inputs": [wavs[1]]}) == (
        200, {"ok": True, "jobs": [1]})
    _drain(server.queue)
    q = json.loads(_get(f"{base}/api/queue"))
    assert q["status"] == "done"
    assert [j["status"] for j in q["jobs"]] == ["done", "done"]
    assert q["jobs"][1]["result"]["subtitles"] == 3
    logs = json.loads(_get(f"{base}/api/logs?job=0&since=1"))
    assert logs["job"] == 0 and logs["queue_status"] == "done"
    assert logs["lines"][0] == "processing in0.wav"
    last = json.loads(_get(f"{base}/api/logs"))
    assert last["job"] == 1 and last["next"] == q["jobs"][1]["log_len"]


class _Spawns:
    """Popen stand-in: records each child and sets ``spawned``; with
    ``hold`` it waits on ``go`` before spawning."""

    def __init__(self, hold=False):
        self.popen = subprocess.Popen     # the real one, before patching
        self.procs, self.hold = [], hold
        self.spawned = threading.Event()
        self.entered = threading.Event()
        self.go = threading.Event()

    def __call__(self, *args, **kwargs):
        self.entered.set()
        if self.hold:
            assert self.go.wait(GUARD_S)
        proc = self.popen(*args, **kwargs)
        self.procs.append(proc)
        self.spawned.set()
        return proc


SLOW = [sys.executable, "-u", "-c",
        "import time; print('processing x', flush=True); time.sleep(120)"]


def test_queue_cancel_all(monkeypatch):
    spawns = _Spawns()
    monkeypatch.setattr(psrv, "build_args", lambda o: SLOW)
    monkeypatch.setattr(psrv.subprocess, "Popen", spawns)
    q = psrv._QueueState()
    q.enqueue(["/fake1.wav", "/fake2.wav"], {})
    assert spawns.spawned.wait(GUARD_S)
    q.cancel()
    _drain(q)
    assert q.status() == "cancelled"
    assert [j["status"] for j in q.summaries()] == ["cancelled"] * 2
    assert len(spawns.procs) == 1 and spawns.procs[0].poll() is not None


def test_queue_cancel_one_running_and_one_queued(monkeypatch, tmp_path):
    """Cancelling the running job terminates its child (a negative exit
    code reads as cancelled); a cancelled queued job never starts; the
    queue goes on with the next one."""
    spawns = _Spawns()
    build, _ = _fake_cli(tmp_path)
    monkeypatch.setattr(psrv, "build_args", lambda o: SLOW if o["inputs"][
        0].endswith("in0.wav") else build(o))
    monkeypatch.setattr(psrv.subprocess, "Popen", spawns)
    q = psrv._QueueState()
    q.enqueue(_wavs(tmp_path, 3), {})
    assert spawns.spawned.wait(GUARD_S)
    q.cancel(1)
    q.cancel(0)
    _drain(q)
    assert [j["status"] for j in q.summaries()] == ["cancelled",
                                                    "cancelled", "done"]
    assert q.status() == "done"
    assert len(spawns.procs) == 2 and spawns.procs[0].returncode < 0
    assert q.job_logs(0, 0)["lines"][-1] == f"[exit {spawns.procs[0].returncode}]"


def test_cancel_before_the_child_spawns(monkeypatch):
    """Departure: a cancel that arrives after the job is running but
    before its child exists terminates the child once it spawns (the JAX
    queue lets that child run to its end)."""
    spawns = _Spawns(hold=True)
    monkeypatch.setattr(psrv, "build_args", lambda o: SLOW)
    monkeypatch.setattr(psrv.subprocess, "Popen", spawns)
    q = psrv._QueueState()
    q.enqueue(["/fake.wav"], {})
    assert spawns.entered.wait(GUARD_S)
    assert q.summaries()[0]["status"] == "running"
    q.cancel(0)
    spawns.go.set()
    _drain(q)
    assert q.summaries()[0]["status"] == "cancelled"
    assert spawns.procs[0].returncode < 0


# --------------------------------------------------- result regex, trace

DAEMON_LINE = ("12:00:00 | INFO     | wrote clip.ja.whisperjav.srt "
               "(7 subtitles, daemon, RTF 12.34x)")
INPROCESS_LINE = ("12:00:00 | INFO     | wrote clip.ja.whisperjav.srt "
                  "(1 subtitle, RTF 3.5x)")


def test_done_regex_reads_the_daemon_line():
    """Departure: the JAX regex misses the --daemon form of the CLI's
    'wrote' line, so a default JAX GUI job never gets its result; the
    port's reads it. Both read the in-process form alike."""
    assert jsrv._DONE_RE.search(DAEMON_LINE) is None
    m = psrv._DONE_RE.search(DAEMON_LINE)
    assert m.groups() == ("clip.ja.whisperjav.srt", "7", "12.34")
    assert psrv._DONE_RE.search(INPROCESS_LINE).groups() == \
        jsrv._DONE_RE.search(INPROCESS_LINE).groups() == (
            "clip.ja.whisperjav.srt", "1", "3.5")


def test_daemon_job_result(monkeypatch, tmp_path):
    monkeypatch.setattr(psrv, "build_args", lambda o: [
        sys.executable, "-c", f"print({DAEMON_LINE!r})"])
    q = psrv._QueueState()
    q.enqueue(_wavs(tmp_path, 1), {})
    _drain(q)
    assert q.summaries()[0]["result"] == {
        "srt": "clip.ja.whisperjav.srt", "subtitles": 7, "rtf_x": 12.34}


class _OneRound:
    """A stop event for the JAX tailer: one read pass, then stop."""

    def __init__(self):
        self.calls = 0

    def wait(self, timeout):
        self.calls += 1
        return self.calls > 1


TRACES = {
    "segmentation": [{"event": "segmentation",
                      "data": {"windows": 12, "scenes": 3}}],
    "segmentation-missing": [{"event": "segmentation", "data": {}}],
    "file-start": [{"event": "file_start",
                    "data": {"file": "a.wav", "duration": 62.6}}],
    "file-complete": [{"event": "file_start", "data": {"duration": 9}},
                      {"event": "file_complete", "data": {"windows": 1}}],
    "unknown-and-bad": [{"event": "config", "data": {"mode": "x"}},
                        "not json", {"event": "batch"}],
    "sequence": [{"event": "config", "data": {}},
                 {"event": "file_start", "data": {"duration": 20.4}},
                 {"event": "segmentation",
                  "data": {"windows": 2, "scenes": 1}},
                 {"event": "file_complete", "data": {}}],
}


class _Tellable:
    """``open`` for the JAX tailer: a text file whose iteration reads
    with ``readline``, so the ``tell`` inside its loop works."""

    def __init__(self, path, mode="r", encoding=None):
        self.f = open(path, mode, encoding=encoding)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()

    def seek(self, pos):
        self.f.seek(pos)

    def tell(self):
        return self.f.tell()

    def __iter__(self):
        return iter(self.f.readline, "")


def _write_trace(path, events):
    path.write_text("".join((e if isinstance(e, str) else json.dumps(e))
                            + "\n" for e in events), encoding="utf-8")


def _port_stages(path):
    job = psrv._Job(0, "a.wav", [])
    stop = threading.Event()
    stop.set()     # one last read, then return
    psrv._QueueState()._tail_trace(job, str(path), stop)
    return job


@pytest.mark.parametrize("events", list(TRACES.values()), ids=list(TRACES))
def test_trace_stages_equal(tmp_path, monkeypatch, events):
    """The stage strings the port's tailer reads from a written JSONL
    equal the JAX tailer's when that one is given a file it can read
    (see the next test); the port also keeps the trail."""
    path = tmp_path / "trace.jsonl"
    _write_trace(path, events)
    monkeypatch.setattr(jsrv, "open", _Tellable, raising=False)
    jjob = jsrv._Job(0, "a.wav", [])
    jsrv._QueueState()._tail_trace(jjob, str(path), _OneRound())
    pjob = _port_stages(path)
    assert pjob.stage == jjob.stage
    assert pjob.stages[-1:] == ([pjob.stage] if pjob.stage else [])
    if events is TRACES["sequence"]:
        assert pjob.stages == ["extracted 20s",
                               "decoding 2 windows (1 scenes)",
                               "sanitizing"]


def test_the_jax_tailer_never_reads_a_trace(tmp_path):
    """Reference fault: the JAX tailer calls ``tell`` inside ``for line
    in f``, which raises OSError on a text file (caught), so a JAX GUI
    job never shows a trace stage; the port's tailer reads it."""
    path = tmp_path / "trace.jsonl"
    _write_trace(path, TRACES["sequence"])
    jjob = jsrv._Job(0, "a.wav", [])
    jsrv._QueueState()._tail_trace(jjob, str(path), _OneRound())
    assert jjob.stage == ""
    assert _port_stages(path).stage == "sanitizing"


def test_a_line_not_yet_ended_waits(tmp_path):
    path = tmp_path / "trace.jsonl"
    path.write_text(json.dumps({"event": "file_complete", "data": {}}),
                    encoding="utf-8")
    assert _port_stages(path).stages == []
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n")
    assert _port_stages(path).stages == ["sanitizing"]


def test_the_tailer_reads_events_written_just_before_exit(tmp_path):
    """Events the child writes just before it exits still reach the job:
    the tailer reads once more after ``stop`` (the JAX tailer returns at
    once)."""
    path = tmp_path / "trace.jsonl"
    path.write_text("", encoding="utf-8")
    job = psrv._Job(0, "a.wav", [])
    stop = threading.Event()
    tailer = threading.Thread(target=psrv._QueueState()._tail_trace,
                              args=(job, str(path), stop), daemon=True)
    tailer.start()
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps({"event": "file_complete", "data": {}}) + "\n")
    stop.set()
    tailer.join(GUARD_S)
    assert not tailer.is_alive()
    assert job.stages == ["sanitizing"]


# ------------------------------------------ the CLI's daemon route, traced

def _stub_daemon(fingerprint):
    stats = {"audio_s": 3.0, "windows": 2, "scenes": 1, "asr_s": 0.1}

    class H(BaseHTTPRequestHandler):
        def _json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._json({"status": "ok", **fingerprint})

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", "0")))
            self._json({"cues": [{"index": 1, "start": 0.5, "end": 1.8,
                                  "text": "こんにちは"}], "stats": stats})

        def log_message(self, *a):
            pass
    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_daemon_route_traces_the_guis_stages(tmp_path, capfd):
    """The port CLI's --daemon route with --trace-params records
    file_start, segmentation and file_complete (the JAX CLI records none
    there), so a default GUI job moves through trace-derived stages; its
    'wrote' line gives the job's result."""
    from whisperjav_tpu_torch.cli import main
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.pipelines.daemon_client import _fingerprint
    wav = tmp_path / "clip.wav"
    write_wav(wav, np.zeros(48000, np.float32), 16000)
    srv = _stub_daemon(_fingerprint(resolve_pipeline_config()))
    trace = tmp_path / "trace.jsonl"
    argv = psrv.build_args({"inputs": str(wav), "no_signature": True,
                            "output_dir": str(tmp_path / "out")})
    try:
        rc = main(argv[3:] + ["--daemon-port", str(srv.server_address[1]),
                              "--trace-params", str(trace)])
    finally:
        srv.shutdown()
        srv.server_close()
    assert rc == 0
    events = [json.loads(ln) for ln in trace.read_text().splitlines()]
    assert [e["event"] for e in events] == ["config", "file_start",
                                            "segmentation", "file_complete"]
    assert events[1]["data"] == {"file": str(wav), "duration": 3.0}
    assert _port_stages(trace).stages == [
        "extracted 3s", "decoding 2 windows (1 scenes)", "sanitizing"]
    out, err = capfd.readouterr()
    wrote = [ln for ln in (out + err).splitlines() if "| wrote " in ln]
    assert len(wrote) == 1 and jsrv._DONE_RE.search(wrote[0]) is None
    assert psrv._DONE_RE.search(wrote[0]).group(2) == "1"


# ---------------------------------------------------- one real CLI job

def test_queue_real_cli_job(tmp_path, gui, monkeypatch):
    """One file through the real port CLI child (tiny model, random
    weights, on the CPU, in-process engine) driven over the GUI's HTTP
    API. The child starts outside the checkout, where the port imports
    only through the PYTHONPATH the queue gives it."""
    base, server = gui
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the child's torch threads
    t = np.arange(16000 * 3) / 16000.0
    write_wav(tmp_path / "clip0.wav",
              (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    out_dir = tmp_path / "out"
    status, r = _post(f"{base}/api/start", {
        "inputs": str(tmp_path / "*.wav"), "mode": "faster",
        "model": "tiny", "device": "cpu", "batch_size": 1,
        "output_dir": str(out_dir), "daemon": False, "no_signature": True,
        "overrides": {"sensitivity.logprob_threshold": -100}})
    assert status == 200 and r == {"ok": True, "jobs": [0]}
    _drain(server.queue)
    job = json.loads(_get(f"{base}/api/queue"))["jobs"][0]
    logs = json.loads(_get(f"{base}/api/logs?job=0"))["lines"]
    assert job["status"] == "done", logs[-30:]
    assert "-m whisperjav_tpu_torch.cli" in logs[0]
    assert "--device cpu" in logs[0] and "--daemon" not in logs[0]
    srt = out_dir / "clip0.ja.whisperjav.srt"
    assert srt.exists()
    assert job["result"]["srt"] == srt.name
    assert "extracted 3s" in job["stages"]
    assert "sanitizing" in job["stages"]
