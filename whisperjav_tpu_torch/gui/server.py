"""``whisperjav-torch-gui``: local web GUI that drives the port's CLI.

The port's copy of ``whisperjav_tpu/gui/server.py``. The GUI process
never loads a model nor touches the device: it builds
``python -m whisperjav_tpu_torch.cli`` argv from UI options, runs one
CLI child per file, and streams its output to the page. A job goes
through the resident engine (``--daemon``, the port's
``whisperjav-torch-serve`` on the card) unless it sets ``daemon``, runs
an ensemble or runs qwen mode, as in the JAX GUI. Where the port
differs:

- the ``device`` option becomes ``--device`` (absent: the CLI's default,
  the card);
- each child gets this checkout on its ``PYTHONPATH``, so it runs from
  any working directory;
- the queue lives on the server object (:func:`make_server`), not in a
  module global, so each server has its own;
- the result regex also reads the ``--daemon`` form of the CLI's
  "wrote" line, so a default job gets its result;
- the trace tailer reads the events (the JAX one fails on its first
  line, see ``_tail_trace``), once more after the child exits, and each
  job keeps the trail of stages it went through (``stages``);
- a cancel that arrives before the job's child has spawned terminates
  the child as soon as it exists;
- the release poll of ``/api/version`` is the server's ``fetch``.

Architecture parity with the reference GUI (reference:
whisperjav/webview_gui/api.py:65-562), rebuilt as a dependency-free
stdlib HTTP server + single-page app, so it runs on a headless GPU host
through port forwarding.

Endpoints: GET / (app), GET /api/schema (modes/sensitivities/backends),
GET /api/component_schema?type=T&name=N, POST /api/start {options},
GET /api/queue, GET /api/logs?job=N&since=M, POST /api/cancel {job},
GET /api/status, GET|POST /api/presets, GET /api/version.

    python -m whisperjav_tpu_torch.gui.server --port 8477
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from whisperjav_tpu_torch.gui.app_page import APP_HTML

# the checkout the CLI children import, installed or not
_ROOT = str(Path(__file__).resolve().parents[2])


def build_args(options: Dict) -> List[str]:
    """UI options dict → whisperjav-torch CLI argv (reference:
    api.py:97-294)."""
    argv: List[str] = [sys.executable, "-m", "whisperjav_tpu_torch.cli"]
    inputs = options.get("inputs") or []
    if isinstance(inputs, str):
        inputs = [inputs]
    argv.extend(inputs)
    simple = {
        "mode": "--mode", "sensitivity": "--sensitivity",
        "model": "--model", "checkpoint": "--checkpoint",
        "language": "--language", "subs_language": "--subs-language",
        "output_dir": "--output-dir", "batch_size": "--batch-size",
        "vad_backend": "--vad-backend", "scene_backend": "--scene-backend",
        "enhancer": "--enhancer", "translate": "--translate",
        "translate_target": "--translate-target",
        "merge_strategy": "--merge-strategy",
        "pass1_sensitivity": "--pass1-sensitivity",
        "pass2_sensitivity": "--pass2-sensitivity",
        "pass1_model": "--pass1-model", "pass2_model": "--pass2-model",
        "output_format": "--output-format",
        "credit": "--credit",
        "beam_size": "--beam-size",
        "vad_threshold": "--vad-threshold",
        "speech_pad_ms": "--speech-pad-ms",
        "prompt": "--prompt",
        "timestamp_mode": "--timestamp-mode",
        "regroup_mode": "--regroup-mode",
        "framer": "--framer",
        "devices": "--devices",
        "task": "--task",
        "device": "--device",
    }
    for key, flag in simple.items():
        val = options.get(key)
        if val not in (None, "", []):
            argv.extend([flag, str(val)])
    # per-backend advanced knobs: the SPA's schema-driven forms post
    # {vad_args: {k: v}, ...} dicts holding only non-default values;
    # each becomes a repeated KEY=VALUE flag (reference exposes the same
    # per-component depth through pydantic forms, webview_gui/api.py:830)
    for key, flag in [("vad_args", "--vad-arg"),
                      ("scene_args", "--scene-arg"),
                      ("enhancer_args", "--enhancer-arg"),
                      ("overrides", "--overrides")]:
        kv = options.get(key)
        if isinstance(kv, dict):
            for k, v in kv.items():
                if isinstance(v, bool):
                    v = "true" if v else "false"
                argv.extend([flag, f"{k}={v}"])
    for key, flag in [("skip_existing", "--skip-existing"),
                      ("make_vtt", "--make-vtt"),
                      ("no_sanitize", "--no-sanitize"),
                      ("ensemble", "--ensemble"),
                      ("keep_temp", "--keep-temp"),
                      ("enhance_for_vad", "--enhance-for-vad"),
                      ("no_signature", "--no-signature"),
                      ("word_timestamps", "--word-timestamps"),
                      ("int8_weights", "--int8-weights"),
                      ("no_vad", "--no-vad"),
                      ("daemon", "--daemon")]:
        if options.get(key):
            argv.append(flag)
    # each fresh CLI process pays the model's load and the CUDA context
    # before its first batch, so GUI jobs default to the resident engine
    # (--daemon) unless the user opts out; the daemon router covers
    # neither ensembles nor qwen mode
    if ("daemon" not in options and not options.get("ensemble")
            and options.get("mode") != "qwen"):
        argv.append("--daemon")
    return argv


# the in-process form "wrote X (N subtitles, RTF Rx)" and the --daemon
# form "wrote X (N subtitles, daemon, RTF Rx)"
_DONE_RE = re.compile(
    r"wrote (\S+) \((\d+) subtitles?(?:, daemon)?, RTF ([0-9.]+)x\)")


class _Job:
    """One queued file: its own argv, logs, stage, and result."""

    def __init__(self, jid: int, path: str, argv: List[str]):
        self.id = jid
        self.path = path
        self.argv = argv
        self.status = "queued"     # queued|running|done|failed|cancelled
        self.stage = ""            # last tracer/log-derived stage detail
        self.stages: List[str] = []    # every stage it went through
        self.cancel_requested = False
        self.logs: List[str] = [f"$ {' '.join(argv)}"]
        self.result: Dict = {}

    def set_stage(self, stage: str) -> None:
        self.stage = stage
        if stage and (not self.stages or self.stages[-1] != stage):
            self.stages.append(stage)

    def summary(self) -> Dict:
        return {"id": self.id, "file": self.path, "status": self.status,
                "stage": self.stage, "stages": list(self.stages),
                "result": self.result, "log_len": len(self.logs)}


class _QueueState:
    """Sequential per-file job queue (one CLI subprocess at a time: one
    card serialises the decode anyway; the reference's GUI also runs one
    whisperjav process per click, webview_gui/api.py:350). Per-file
    progress comes from the CLI's log lines plus the parameter tracer's
    JSONL events (--trace-params), giving the UI live stage/stats without
    the GUI ever loading a model."""

    def __init__(self):
        self.jobs: List[_Job] = []
        self.lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        self.current: Optional[_Job] = None
        self._worker: Optional[threading.Thread] = None
        self._cancel_all = False

    # -------------------------------------------------------------- api
    def enqueue(self, inputs: List[str], options: Dict) -> List[int]:
        """One job per discovered file (glob/dir expansion server-side so
        the queue shows real files); falls back to one job per raw input
        when discovery finds nothing (the CLI then errors visibly)."""
        files: List[str] = []
        try:
            from whisperjav_tpu_torch.modules.media_discovery import discover
            for inp in inputs:
                found = [str(m.path) for m in discover([inp])]
                files.extend(found or [inp])
        except Exception:
            files = list(inputs)
        ids = []
        with self.lock:
            base = len(self.jobs)
            for i, f in enumerate(files):
                per_file = dict(options)
                per_file["inputs"] = [f]
                job = _Job(base + i, f, build_args(per_file))
                self.jobs.append(job)
                ids.append(job.id)
            self._cancel_all = False
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run_queue,
                                                daemon=True)
                self._worker.start()
        return ids

    def cancel(self, job_id: Optional[int] = None) -> None:
        with self.lock:
            if job_id is None:
                self._cancel_all = True
                for j in self.jobs:
                    if j.status == "queued":
                        j.status = "cancelled"
                if self.proc is not None and self.proc.poll() is None:
                    self.proc.terminate()
            else:
                for j in self.jobs:
                    if j.id == job_id:
                        if j.status == "queued":
                            j.status = "cancelled"
                        elif j is self.current:
                            # a child not spawned yet is terminated by
                            # _run_one as soon as it exists
                            j.cancel_requested = True
                            if self.proc is not None \
                                    and self.proc.poll() is None:
                                self.proc.terminate()

    def status(self) -> str:
        with self.lock:
            if any(j.status == "running" for j in self.jobs):
                return "running"
            if any(j.status == "queued" for j in self.jobs):
                return "queued"
            if not self.jobs:
                return "idle"
            if all(j.status == "cancelled" for j in self.jobs):
                return "cancelled"
            return ("done" if all(j.status in ("done", "cancelled")
                                  for j in self.jobs) else "failed")

    def summaries(self) -> List[Dict]:
        with self.lock:
            return [j.summary() for j in self.jobs]

    def job_logs(self, job_id: int, since: int) -> Dict:
        with self.lock:
            for j in self.jobs:
                if j.id == job_id:
                    return {"lines": j.logs[since:], "next": len(j.logs),
                            "status": j.status}
        return {"lines": [], "next": 0, "status": "unknown"}

    # ----------------------------------------------------------- worker
    def _run_queue(self) -> None:
        while True:
            with self.lock:
                nxt = next((j for j in self.jobs if j.status == "queued"),
                           None)
                if nxt is None or self._cancel_all:
                    self.current = None
                    return
                nxt.status = "running"
                nxt.set_stage("starting")
                self.current = nxt
            self._run_one(nxt)

    def _run_one(self, job: _Job) -> None:
        trace_path = None
        argv = list(job.argv)
        try:
            fd, trace_path = tempfile.mkstemp(suffix=".jsonl",
                                              prefix="wjav_gui_trace_")
            os.close(fd)
            argv += ["--trace-params", trace_path]
        except OSError:
            trace_path = None
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        try:
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, bufsize=1, env=env)
        except OSError as e:
            with self.lock:
                job.status = "failed"
                job.logs.append(f"[spawn error: {e}]")
            return
        with self.lock:
            self.proc = proc
            if job.cancel_requested or self._cancel_all:
                proc.terminate()
        stop_tail = threading.Event()
        tailer = threading.Thread(
            target=self._tail_trace, args=(job, trace_path, stop_tail),
            daemon=True)
        if trace_path:
            tailer.start()
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            with self.lock:
                job.logs.append(line)
                if "processing" in line:
                    job.set_stage("processing")
                m = _DONE_RE.search(line)
                if m:
                    job.result = {"srt": m.group(1),
                                  "subtitles": int(m.group(2)),
                                  "rtf_x": float(m.group(3))}
        code = proc.wait()
        stop_tail.set()
        if trace_path:
            tailer.join(timeout=2.0)
            try:
                os.unlink(trace_path)
            except OSError:
                pass
        with self.lock:
            if job.status != "cancelled":
                job.status = ("done" if code == 0 else
                              "cancelled" if code < 0 else
                              "failed")
            job.stage = "" if job.status == "done" else job.stage
            job.logs.append(f"[exit {code}]")

    def _tail_trace(self, job: _Job, path: str,
                    stop: threading.Event) -> None:
        """Follow the CLI's --trace-params JSONL; each event becomes the
        job's live stage detail (utils/tracer.py event stream). Once
        ``stop`` is set the file is read one last time, so events the
        child wrote just before it exited still count. Lines are read
        with ``readline``: the JAX tailer calls ``tell`` inside ``for line
        in f``, which raises OSError on a text file, so it never shows a
        trace stage. A line not yet ended is left for the next read."""
        pos = 0
        while True:
            stopped = stop.wait(0.5)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(pos)
                    for line in iter(f.readline, ""):
                        if not line.endswith("\n"):
                            break
                        pos = f.tell()
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        name = ev.get("event", "")
                        data = ev.get("data", {})
                        with self.lock:
                            if name == "segmentation":
                                job.set_stage(
                                    f"decoding {data.get('windows', '?')} "
                                    f"windows ({data.get('scenes', '?')} "
                                    "scenes)")
                            elif name == "file_start":
                                job.set_stage(
                                    f"extracted "
                                    f"{data.get('duration', 0):.0f}s")
                            elif name == "file_complete":
                                job.set_stage("sanitizing")
            except OSError:
                pass
            if stopped:
                return


def schema() -> Dict:
    from whisperjav_tpu_torch.config.presets import (
        MODE_PRESETS, SENSITIVITY_PRESETS,
    )
    from whisperjav_tpu_torch.ensemble.merge import MERGE_STRATEGIES
    return {
        "modes": {k: v.description for k, v in MODE_PRESETS.items()},
        "sensitivities": sorted(SENSITIVITY_PRESETS),
        "vad_backends": ["energy", "silero", "ten", "whisperseg",
                         "whisper-vad", "none"],
        "scene_backends": ["energy", "semantic", "silero", "none"],
        "enhancers": ["none", "dsp", "zipenhancer", "clearvoice",
                      "bs-roformer"],
        "merge_strategies": sorted(MERGE_STRATEGIES),
        "translate_providers": ["", "identity", "deepseek", "gpt", "claude",
                                "gemini", "ollama", "tpu-local"],
        # per-backend parameter schemas live at
        # /api/component_schema?type=<T>&name=<N> (reference:
        # webview_gui/api.py:830 get_component_schema)
        "component_types": sorted(_COMPONENT_CONFIGS),
    }


# per-backend config dataclasses — the authoritative source of each
# backend's KEY=VALUE parameters (the reference exposes pydantic
# schemas per component, webview_gui/api.py:830-960; here the config
# dataclasses play that role)
_COMPONENT_CONFIGS: Dict[str, Dict[str, str]] = {
    "segmenter": {
        "energy": "whisperjav_tpu_torch.modules.segmentation.energy_vad"
                  ":EnergyVadConfig",
        "silero": "whisperjav_tpu_torch.modules.segmentation.silero"
                  ":SileroJaxConfig",
        "ten": "whisperjav_tpu_torch.modules.segmentation.ten"
               ":TenJaxConfig",
        "whisperseg": "whisperjav_tpu_torch.modules.segmentation"
                      ".whisperseg:WhisperSegConfig",
        "whisper-vad": "whisperjav_tpu_torch.modules.segmentation"
                       ".whisper_vad:WhisperVadConfig",
    },
    "scene": {
        "energy": "whisperjav_tpu_torch.modules.scene_detection.energy"
                  ":EnergySceneConfig",
        "semantic": "whisperjav_tpu_torch.modules.scene_detection.semantic"
                    ":SemanticSceneConfig",
        "silero": "whisperjav_tpu_torch.modules.scene_detection"
                  ".silero_scene:SileroSceneConfig",
    },
    "enhancer": {
        "dsp": "whisperjav_tpu_torch.modules.enhancement.dsp:DspConfig",
        "zipenhancer": "whisperjav_tpu_torch.modules.enhancement"
                       ".zipenhancer:ZipEnhancerConfig",
        "clearvoice": "whisperjav_tpu_torch.modules.enhancement"
                      ".bandsplit_backends:_HeavyConfig",
        "bs-roformer": "whisperjav_tpu_torch.modules.enhancement"
                       ".bandsplit_backends:_HeavyConfig",
    },
    "sanitizer": {
        "default": "whisperjav_tpu_torch.modules.sanitize.sanitizer"
                   ":SanitizerConfig",
        "cross-subtitle": "whisperjav_tpu_torch.modules.sanitize"
                          ".cross_subtitle:CrossSubtitleConfig",
    },
}


def component_schema(ctype: str, name: str) -> Dict:
    """Field-level parameter schema for one backend, introspected from
    its config dataclass: name, type, default per field."""
    import dataclasses
    import importlib

    try:
        spec = _COMPONENT_CONFIGS[ctype][name]
    except KeyError:
        return {"success": False,
                "error": f"unknown component {ctype}/{name}"}
    mod_name, cls_name = spec.split(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    inst = cls()
    fields = []
    for f in dataclasses.fields(cls):
        default = getattr(inst, f.name)
        fields.append({
            "name": f.name,
            "type": type(default).__name__ if default is not None
            else "str",
            "default": default if isinstance(
                default, (int, float, str, bool, type(None))) else
            str(default),
        })
    return {"success": True, "component": name, "type": ctype,
            "fields": fields}


class Handler(BaseHTTPRequestHandler):
    """The API over ``self.server.queue`` and ``self.server.fetch`` (see
    :func:`make_server`)."""

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        url = urlparse(self.path)
        queue = self.server.queue
        if url.path in ("/", "/index.html"):
            self._send(200, APP_HTML.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/schema":
            self._json(schema())
        elif url.path == "/api/component_schema":
            q = parse_qs(url.query)
            self._json(component_schema(
                q.get("type", [""])[0], q.get("name", [""])[0]))
        elif url.path == "/api/status":
            self._json({"status": queue.status()})
        elif url.path == "/api/queue":
            self._json({"jobs": queue.summaries(), "status": queue.status()})
        elif url.path == "/api/presets":
            from whisperjav_tpu_torch.config.user_config import (
                UserConfigManager,
            )
            m = UserConfigManager()
            self._json({name: m.get_preset(name)
                        for name in m.list_presets()})
        elif url.path == "/api/version":
            # update checker (reference: webview_gui update_checker +
            # api.py check_for_updates); graceful when offline
            from whisperjav_tpu_torch.utils.version_check import (
                check_latest_version,
            )
            from whisperjav_tpu_torch.version import __version__
            info = check_latest_version(timeout=3.0,
                                        fetch=self.server.fetch)
            self._json({"version": __version__,
                        "latest": info["latest"] if info else None,
                        "update_available": bool(info and info["newer"]),
                        "checked": info is not None})
        elif url.path == "/api/logs":
            q = parse_qs(url.query)
            since = int(q.get("since", ["0"])[0])
            jobs = queue.summaries()
            if "job" in q:
                jid = int(q["job"][0])
            elif jobs:       # default: the running job, else the last one
                running = [j for j in jobs if j["status"] == "running"]
                jid = (running or jobs)[-1]["id"]
            else:
                self._json({"lines": [], "next": 0, "status": "idle"})
                return
            out = queue.job_logs(jid, since)
            out["job"] = jid
            out["queue_status"] = queue.status()
            self._json(out)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        length = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(length) or b"{}")
        if url.path == "/api/start":
            inputs = body.get("inputs") or []
            if isinstance(inputs, str):
                inputs = [inputs]
            if not inputs:
                self._json({"ok": False, "error": "no inputs"}, 400)
                return
            ids = self.server.queue.enqueue(inputs, body)
            self._json({"ok": True, "jobs": ids})
        elif url.path == "/api/cancel":
            self.server.queue.cancel(body.get("job"))
            self._json({"ok": True})
        elif url.path == "/api/presets":
            from whisperjav_tpu_torch.config.user_config import (
                UserConfigManager,
            )
            m = UserConfigManager()
            try:
                if body.get("delete"):
                    self._json({"ok": m.delete_preset(body["name"])})
                else:
                    m.save_preset(body["name"], body.get("options", {}))
                    self._json({"ok": True})
            except (ValueError, KeyError) as e:
                self._json({"ok": False, "error": str(e)}, 400)
        else:
            self._json({"error": "not found"}, 404)

    def log_message(self, fmt, *args):  # silence request logging
        pass


def make_server(host: str = "127.0.0.1", port: int = 0,
                fetch: Optional[Callable[[float], Dict]] = None
                ) -> ThreadingHTTPServer:
    """A threading HTTP server answering the GUI's API with a job queue
    of its own (port 0: any free port, read back from
    ``server_address``). ``fetch`` is the release poll of
    ``/api/version`` (default: ``version_check.fetch_release``)."""
    server = ThreadingHTTPServer((host, port), Handler)
    server.queue = _QueueState()
    server.fetch = fetch
    return server


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="whisperjav-torch-gui")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    args = p.parse_args(argv)
    server = make_server(args.host, args.port)
    print(f"whisperjav-torch GUI: http://{args.host}:{args.port}/",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
