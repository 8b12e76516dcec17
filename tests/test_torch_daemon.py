"""The port's resident-engine routing (``whisperjav-torch --daemon``,
``pipelines/daemon_client.py``) and its separation from the JAX
package's daemon: each client rejects the other's fingerprint in both
directions (the port's names the torch backend and salts its config
hash with it), the CLI writes real SRTs from a matching daemon's cues
without building a pipeline, falls back in-process where a daemon can't
receive the invocation's settings, replaces a mismatched daemon on
request, and autostarts ``python -m whisperjav_tpu_torch.serve``.
Servers bind port 0; waits are joins and polls with generous limits."""

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from whisperjav_tpu.config.presets import (
    resolve_pipeline_config as j_resolve,
)
from whisperjav_tpu.pipelines import daemon_client as jdc
from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
from whisperjav_tpu_torch.modules.audio_io import write_wav
from whisperjav_tpu_torch.pipelines import daemon_client
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

CUES = [{"index": 1, "start": 0.5, "end": 1.8, "text": "こんにちは"},
        {"index": 2, "start": 2.0, "end": 3.0, "text": "テスト"}]


def _stub_server(fingerprint, cues=CUES):
    """A daemon that answers /health with ``fingerprint``, /transcribe
    with ``cues`` and stops on /shutdown."""
    class H(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json({"status": "ok", **fingerprint})
            else:
                self._json({"error": "nope"}, 404)

        def do_POST(self):
            if self.path == "/shutdown":
                self._json({"status": "shutting down"})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n))
            assert req.get("format") == "json"
            self._json({"cues": cues, "stats": {"audio_s": 3.0}})

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _cfg(**kw):
    base = dict(mode="balanced", sensitivity="balanced", language="ja",
                model=None, batch_size=8)
    base.update(kw)
    return resolve_pipeline_config(**base)


def _fp(cfg):
    return daemon_client._fingerprint(cfg)


@pytest.mark.parametrize("mode", ["balanced", "qwen", "fidelity"])
def test_fingerprints_name_the_backend(mode):
    """Same settings, two packages: the same human-readable fields, the
    port's backend key, and config hashes that differ (the port's is
    salted with the backend)."""
    kw = dict(mode=mode, sensitivity="balanced", language="ja",
              batch_size=8)
    port = _fp(resolve_pipeline_config(**kw))
    jax_fp = jdc._fingerprint(j_resolve(**kw))
    assert port.pop("backend") == "torch" and "backend" not in jax_fp
    assert port.pop("cfg_hash") != jax_fp.pop("cfg_hash")
    assert port == jax_fp


def test_each_client_rejects_the_other_daemon():
    cfg, jcfg = _cfg(), j_resolve(mode="balanced", sensitivity="balanced",
                                  language="ja", batch_size=8)
    for fingerprint, port_ok, jax_ok in ((_fp(cfg), True, False),
                                         (jdc._fingerprint(jcfg), False,
                                          True)):
        srv, port = _stub_server(fingerprint)
        try:
            assert (daemon_client.find_daemon(cfg, port) is not None) \
                == port_ok
            assert (jdc.find_daemon(jcfg, port) is not None) == jax_ok
        finally:
            srv.shutdown()
            srv.server_close()


def test_the_jax_client_rejects_the_port_service():
    """The real service: the port's /health (fingerprint of the JAX
    package's config resolved by the port) is refused by the JAX client
    and accepted by the port's."""
    from whisperjav_tpu_torch import serve

    class QwenPipeline:
        def process_audio(self, audio, rate):
            return [], {}

    cfg = _cfg()
    svc = serve.TranscriptionService(QwenPipeline(), device="cpu",
                                     fingerprint=_fp(cfg))
    httpd = serve.make_server(svc)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    port = httpd.server_address[1]
    try:
        assert daemon_client.find_daemon(cfg, port) is not None
        assert jdc.find_daemon(j_resolve(mode="balanced",
                                         sensitivity="balanced",
                                         language="ja", batch_size=8),
                               port) is None
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=60)


def test_find_daemon_rejects_mismatch_and_absence():
    srv, port = _stub_server(dict(_fp(_cfg()), model="large-v2"))
    try:
        assert daemon_client.find_daemon(_cfg(), port) is None
    finally:
        srv.shutdown()
        srv.server_close()
    assert daemon_client.find_daemon(_cfg(), port=1) is None


def test_client_transcribe_builds_subtitles(tmp_path):
    srv, port = _stub_server(_fp(_cfg()))
    try:
        subs, stats = daemon_client.DaemonClient(port).transcribe(
            tmp_path / "x.wav")
        assert [s.text for s in subs] == ["こんにちは", "テスト"]
        assert subs[0].start == 0.5 and stats["audio_s"] == 3.0
    finally:
        srv.shutdown()
        srv.server_close()


def _wav(tmp_path, seconds=1.0):
    path = tmp_path / "clip.wav"
    write_wav(path, (0.05 * np.random.default_rng(0).standard_normal(
        int(16000 * seconds))).astype(np.float32), 16000)
    return path


def _boom(*a, **k):
    raise AssertionError("the daemon route must not build a pipeline")


@pytest.mark.parametrize("mode", ["balanced", "qwen"])
def test_cli_daemon_routes_and_writes_srt(tmp_path, monkeypatch, mode):
    """Flagless CLI + --daemon + a matching daemon: the SRT and metadata
    are written from the daemon's cues; no pipeline, engine or qwen stack
    is built in-process."""
    import whisperjav_tpu_torch.modules.subtitle_pipeline.components as comp
    import whisperjav_tpu_torch.pipelines.factory as factory
    from whisperjav_tpu_torch.cli import main
    monkeypatch.setattr(factory, "build_pipeline", _boom)
    monkeypatch.setattr(comp, "QwenGenerator", _boom)
    wav = _wav(tmp_path)
    srv, port = _stub_server(_fp(_cfg(mode=mode, batch_size=None)))
    out = tmp_path / "out"
    try:
        rc = main([str(wav), "--mode", mode, "--daemon", "--daemon-port",
                   str(port), "--output-dir", str(out), "--no-signature"])
    finally:
        srv.shutdown()
        srv.server_close()
    assert rc == 0
    text = (out / "clip.ja.whisperjav.srt").read_text(encoding="utf-8")
    assert "こんにちは" in text and "00:00:00,500" in text
    meta = json.loads((out / "clip.whisperjav.json").read_text())
    assert meta["pipeline"] == mode and meta["duration_s"] == 3.0
    assert meta["stats"]["daemon_client_wall_s"] >= 0


@pytest.mark.parametrize("flags", [["--mode", "qwen", "--no-step-down"],
                                   ["--vad-backend", "whisper-vad"],
                                   ["--beam-size", "5"]])
def test_cli_daemon_falls_through_in_process(tmp_path, monkeypatch, flags):
    """Qwen stack knobs and config overrides a daemon can't receive keep
    the CLI in-process, even with a plain-config daemon on the port."""
    import whisperjav_tpu_torch.modules.subtitle_pipeline.components as comp
    import whisperjav_tpu_torch.pipelines.factory as factory
    from whisperjav_tpu_torch.cli import main

    class Reached(Exception):
        pass

    def reached(*a, **k):
        raise Reached

    monkeypatch.setattr(factory, "build_pipeline", reached)
    monkeypatch.setattr(comp, "QwenGenerator", reached)
    mode = flags[1] if flags[0] == "--mode" else "balanced"
    srv, port = _stub_server(_fp(_cfg(mode=mode, batch_size=None)))
    try:
        with pytest.raises(Reached):
            main([str(_wav(tmp_path)), "--daemon", "--daemon-port",
                  str(port), "--output-dir", str(tmp_path / "o"), *flags])
    finally:
        srv.shutdown()
        srv.server_close()


def test_daemon_reproducible_gate():
    assert daemon_client.daemon_reproducible(_cfg())
    assert daemon_client.daemon_reproducible(_cfg(mode="qwen"))
    assert not daemon_client.daemon_reproducible(
        _cfg(vad_backend="whisper-vad"))
    assert not daemon_client.daemon_reproducible(_cfg(beam_size=5))


def test_get_daemon_replace_stops_mismatched(monkeypatch):
    srv, port = _stub_server(_fp(_cfg(batch_size=4)))
    started = []
    monkeypatch.setattr(
        daemon_client, "start_daemon",
        lambda c, p, checkpoint=None, device="cuda":
        started.append((p, device)) or "CLIENT")
    assert daemon_client.get_daemon(_cfg(), port=port, replace=True,
                                    device="cpu") == "CLIENT"
    assert started == [(port, "cpu")]
    assert daemon_client._health(port) is None      # the stub stopped
    srv.server_close()


def test_get_daemon_without_replace_falls_back(monkeypatch):
    srv, port = _stub_server(_fp(_cfg(batch_size=4)))
    try:
        monkeypatch.setattr(
            daemon_client, "start_daemon",
            lambda *a, **k: pytest.fail("must not autostart over an "
                                        "occupied port without replace"))
        assert daemon_client.get_daemon(_cfg(), port=port) is None
        assert daemon_client._health(port) is not None   # untouched
    finally:
        srv.shutdown()
        srv.server_close()


def test_autostart_runs_the_port_serve_module(tmp_path, monkeypatch):
    """``start_daemon`` launches ``python -m whisperjav_tpu_torch.serve``
    (here on the CPU with the tiny model), waits for its matching
    /health, and ``stop_daemon`` frees the port."""
    monkeypatch.setenv("WJAV_CACHE_DIR", str(tmp_path))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cfg = _cfg(model="tiny", batch_size=2)
    client = daemon_client.start_daemon(cfg, port, device="cpu",
                                        wait_s=240)
    try:
        assert client is not None and client.port == port
        health = daemon_client._health(port)
        assert health["device"] == "cpu" and health["backend"] == "torch"
        assert health["model"] == "tiny"
    finally:
        assert daemon_client.stop_daemon(port, wait_s=60)
    assert daemon_client._health(port) is None
    log = (tmp_path / f"serve-{port}.log").read_text()
    assert "whisperjav-torch-serve" in log
