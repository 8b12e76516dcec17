"""``whisperjav-torch-serve``: a transcription service with a resident engine.

The port's copy of ``whisperjav_tpu/serve.py``. The reference's GUI
spawns a fresh CLI process per job and reloads its models each time
(reference: webview_gui/api.py:350). Here the engine stays loaded on
the device; each request pays only its own preprocessing and decode.

API (JSON over HTTP, stdlib only):
  GET  /health                  → {status, model, device, backend, the
                                   config fingerprint}
  POST /transcribe              → body: {"path": "/abs/file.wav",
                                   "language": "ja", "format": "srt|json"}
                                   or raw WAV bytes with
                                   Content-Type: audio/wav
  POST /shutdown                → stops the server (``--daemon-stop``)
Responses: SRT text or JSON cue list + stats.

The Whisper engine runs on one card; ``--devices N`` shards its window
batches over the first N cards (the JAX server shards over every device
by default, see ``parallel/mesh.py``); the qwen engine runs on
``--device``.

    whisperjav-torch-serve --port 8478                  # on cuda
    whisperjav-torch-serve --device cpu --model tiny --port 8478
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.pipelines.engine import device_label
from whisperjav_tpu_torch.utils.logger import logger, setup_logger


class WindowCoalescer:
    """Cross-request micro-batching: decode windows from CONCURRENT
    requests in shared engine batches.

    Each HTTP thread preprocesses its own audio (scenes/VAD — host work),
    then submits its window list here. A single device thread drains the
    queue, waiting up to ``linger_ms`` to let concurrent requests pile
    in, concatenates everything, and runs ONE ``transcribe_windows``
    pass — so ten 1-window requests cost one padded batch instead of
    ten. Results route back by window identity.
    """

    def __init__(self, engine, linger_ms: float = 30.0):
        import queue
        self.engine = engine
        self.linger_s = linger_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    class _Req:
        __slots__ = ("windows", "event", "result", "error")

        def __init__(self, windows):
            self.windows = windows
            self.event = threading.Event()
            self.result = None
            self.error = None

    def submit(self, windows):
        req = self._Req(windows)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _worker(self):
        import queue
        while True:
            reqs = [self._q.get()]
            deadline = time.monotonic() + self.linger_s
            cap = max(self.engine.batch_size * 4, 1)
            while sum(len(r.windows) for r in reqs) < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    reqs.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                all_windows = [w for r in reqs for w in r.windows]
                results = self.engine.transcribe_windows(all_windows)
                by_id = {id(w): (w, segs) for w, segs in results}
                for r in reqs:
                    r.result = [by_id[id(w)] for w in r.windows]
            except Exception as e:  # noqa: BLE001 — unblock waiters
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.event.set()


class TranscriptionService:
    """Owns one pipeline; coalesces concurrent requests into shared
    device batches (``linger_ms=0`` restores strict serialization).
    ``fingerprint`` (the daemon router's config fingerprint) is reported
    by /health."""

    def __init__(self, pipeline, language: str = "ja",
                 linger_ms: float = 30.0, device="cuda",
                 fingerprint: Optional[dict] = None):
        self.pipeline = pipeline
        self.language = language
        self.device = device
        self.fingerprint = dict(fingerprint or {})
        self.lock = threading.Lock()   # host-side assemble state
        # qwen mode: the decoupled stack (pipelines/qwen.py) manages its
        # own scene-pooled device batches — no window coalescer, and the
        # full request runs under the lock (scene detector + generator
        # carry host state).
        self.is_qwen = not hasattr(pipeline, "engine")
        self.coalescer = (WindowCoalescer(pipeline.engine, linger_ms)
                          if linger_ms > 0 and not self.is_qwen else None)

    def model_name(self) -> str:
        if self.is_qwen:
            return self.fingerprint.get("model")
        return self.pipeline.engine.config.name

    def transcribe_array(self, audio: np.ndarray, sample_rate: int):
        from whisperjav_tpu_torch.modules.audio_io import (
            WHISPER_SAMPLE_RATE, resample,
        )
        if self.is_qwen:
            with self.lock:
                return self.pipeline.process_audio(audio, sample_rate)
        if sample_rate != WHISPER_SAMPLE_RATE:
            audio = resample(audio, sample_rate, WHISPER_SAMPLE_RATE)
        if self.coalescer is None:
            with self.lock:
                subs, stats = self.pipeline.process_audio(
                    audio, WHISPER_SAMPLE_RATE)
        else:
            t0 = time.time()
            # scene/VAD backends may carry internal state — serialize the
            # host stage; the coalescer's shared device batches are where
            # the concurrency win is
            with self.lock:
                windows, stats = self.pipeline.collect_windows(
                    audio, WHISPER_SAMPLE_RATE)
            t_seg = time.time() - t0
            t0 = time.time()
            results = self.coalescer.submit(windows)  # shared device batch
            t_asr = time.time() - t0
            with self.lock:                           # assemble is stateful
                subs = self.pipeline.assemble_subtitles(results)
            stats.update({
                "segmentation_s": round(t_seg, 3),
                "asr_s": round(t_asr, 3),
                "audio_s": round(len(audio) / WHISPER_SAMPLE_RATE, 3),
                "raw_subtitles": len(subs),
                "coalesced": True,
            })
        if self.pipeline.postprocessor is not None:
            subs, san = self.pipeline.postprocessor.process(
                subs, language=self.language)
            stats["sanitization"] = san
        return subs, stats

    def transcribe_path(self, path: str):
        from whisperjav_tpu_torch.modules.audio_io import (
            WHISPER_SAMPLE_RATE, load_audio,
        )
        audio = load_audio(path, WHISPER_SAMPLE_RATE)
        return self.transcribe_array(audio, WHISPER_SAMPLE_RATE)


class Handler(BaseHTTPRequestHandler):
    """The API over ``self.server.service`` (see :func:`make_server`)."""

    def _send(self, code, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj, ensure_ascii=False).encode())

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            service = self.server.service
            body = {"status": "ok", "model": service.model_name(),
                    "device": device_label(service.device)}
            # config fingerprint: the CLI's --daemon router only reuses a
            # daemon whose settings match the invocation
            # (pipelines/daemon_client.py)
            body.update(service.fingerprint)
            self._json(body)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        if self.path == "/shutdown":
            # orderly resident-engine stop (CLI: --daemon-stop): frees
            # the device's memory for a different-config daemon
            self._json({"status": "shutting down"})
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return
        if self.path != "/transcribe":
            self._json({"error": "not found"}, 404)
            return
        service = self.server.service
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "application/json")
        try:
            if ctype.startswith("audio/"):
                from whisperjav_tpu_torch.modules.audio_io import read_wav
                import tempfile
                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(raw)
                    f.flush()
                    audio, rate = read_wav(f.name)
                subs, stats = service.transcribe_array(audio, rate)
                fmt = "srt"
            else:
                req = json.loads(raw or b"{}")
                path = req.get("path")
                if not path or not Path(path).exists():
                    self._json({"error": f"file not found: {path}"}, 400)
                    return
                subs, stats = service.transcribe_path(path)
                fmt = req.get("format", "srt")
        except Exception as e:  # noqa: BLE001 — service must stay alive
            logger.error("transcribe request failed: %s", e, exc_info=True)
            self._json({"error": str(e)}, 500)
            return

        if fmt == "json":
            self._json({
                "cues": [{"index": s.index, "start": s.start,
                          "end": s.end, "text": s.text} for s in subs],
                "stats": stats,
            })
        else:
            from whisperjav_tpu_torch.modules.srt import compose_srt
            self._send(200, compose_srt(subs).encode(),
                       "text/plain; charset=utf-8")

    def log_message(self, fmt, *args):
        pass


def make_server(service: TranscriptionService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """A threading HTTP server answering the API for ``service`` (port 0:
    any free port, read back from ``server_address``)."""
    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service
    return server


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="whisperjav-torch-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8478)
    p.add_argument("--mode", default="balanced")
    p.add_argument("--sensitivity", default="balanced")
    p.add_argument("--model", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--language", default="ja")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the mode's measured optimum")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda)")
    p.add_argument("--devices", type=int, default=None,
                   help="cards to shard window batches over "
                        "(default: one)")
    p.add_argument("--coalesce-ms", type=float, default=30.0,
                   help="micro-batching linger: concurrent requests' "
                        "windows share engine batches (0 = serialize)")
    args = p.parse_args(argv)

    setup_logger("info")
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor
    from whisperjav_tpu_torch.pipelines.daemon_client import _fingerprint

    cfg = resolve_pipeline_config(
        mode=args.mode, sensitivity=args.sensitivity,
        language=args.language, model=args.model,
        batch_size=args.batch_size)
    if cfg.mode.name == "qwen":
        # resident qwen engine: the default decoupled stack
        # (qwen_factory); the qwen pipeline sanitizes internally
        from whisperjav_tpu_torch.pipelines.qwen_factory import (
            build_qwen_pipeline,
        )
        pipeline = build_qwen_pipeline(cfg, checkpoint=args.checkpoint,
                                       device=args.device)
    else:
        from whisperjav_tpu_torch.parallel.mesh import DevicesConflict
        from whisperjav_tpu_torch.pipelines.factory import build_pipeline
        try:
            pipeline = build_pipeline(cfg, checkpoint=args.checkpoint,
                                      postprocessor=SRTPostProcessor(),
                                      device=args.device,
                                      devices=args.devices)
        except DevicesConflict as e:
            print(f"whisperjav-torch-serve: {e}", file=sys.stderr)
            return 2

    service = TranscriptionService(pipeline, args.language,
                                   linger_ms=args.coalesce_ms,
                                   device=args.device,
                                   fingerprint=_fingerprint(cfg))
    server = make_server(service, args.host, args.port)
    logger.info("whisperjav-torch-serve: http://%s:%d (model %s on %s, "
                "resident engine)", args.host, args.port, cfg.model,
                device_label(args.device))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    logger.info("whisperjav-torch-serve: stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
