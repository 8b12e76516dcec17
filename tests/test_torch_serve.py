"""The port's resident transcription service (``whisperjav_tpu_torch/
serve.py``) against the JAX package's: the same SRT served on the same
tiny-Whisper weights, the HTTP API (health, JSON and WAV bodies, 404 and
400, /shutdown and ``--daemon-stop``), the window coalescer sharing one
engine pass between concurrent requests and propagating errors, and the
qwen branch. Servers bind port 0; every wait is on an event or a join
with a generous timeout, never on a clock budget."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisperjav_tpu.serve as jserve
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu_torch import serve
from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.modules.audio_io import write_wav
from whisperjav_tpu_torch.modules.srt import Subtitle
from whisperjav_tpu_torch.pipelines.daemon_client import _fingerprint
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

_DIMS = dict(name="serve-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=1, n_text_state=64,
             n_text_head=4, n_text_layer=1, n_vocab=51865)
SR = 16000
WAIT_S = 120          # generous: joins and waits never set the pace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _clip(seed):
    gap = np.zeros(SR, np.float32)
    return np.concatenate([gap, speech(4, seed), gap, speech(3, seed + 1),
                           gap])


def _options(mod):
    return mod.DecodeOptions(max_new_tokens=12, beam_size=2,
                             cross_kv_int8=True)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX and the port's balanced pipeline over the same tiny
    weights (f32 on the CPU, t=0 beam rung only), without the sanitizer,
    which drops every cue of the random weights' text."""
    from whisperjav_tpu.models.whisper import decode as jd
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu.pipelines.transcribe import (
        TranscribePipeline as JPipe,
    )
    from whisperjav_tpu_torch.models.whisper import decode as td
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
    from whisperjav_tpu_torch.pipelines import engine as te
    from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline
    params = init_params(WhisperConfig(**_DIMS), jax.random.PRNGKey(3))
    vad = {"threshold": 0.28, "max_group_duration_s": 29.0}
    jeng = je.TranscriptionEngine(
        WhisperConfig(**_DIMS), params, options=_options(jd),
        thresholds=je.QualityThresholds(temperatures=(0.0,)), batch_size=2,
        mesh=None, compute_dtype=jnp.float32)
    teng = te.TranscriptionEngine(
        TorchWhisperConfig(**_DIMS),
        params_from_jax(jax.tree.map(np.asarray, params),
                        TorchWhisperConfig(**_DIMS)),
        options=_options(td),
        thresholds=te.QualityThresholds(temperatures=(0.0,)), batch_size=2,
        device="cpu", compute_dtype=torch.float32)
    return (JPipe(jeng, vad_backend="silero", vad_kwargs=vad),
            TranscribePipeline(teng, vad_backend="silero", vad_kwargs=vad))


@pytest.fixture(scope="module")
def server(pipelines):
    svc = serve.TranscriptionService(
        pipelines[1], device="cpu",
        fingerprint=_fingerprint(resolve_pipeline_config(batch_size=2)))
    httpd = serve.make_server(svc)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=WAIT_S)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT_S) as r:
        return r.status, r.read()


def _post(port, path, data, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.status, r.read()


def _http_error(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args)
    return e.value.code, json.loads(e.value.read())


def test_health_reports_model_device_and_fingerprint(server, pipelines):
    """/health: the device, and the config fingerprint (whose model, as
    in the JAX service, names the resolved config's model); without a
    fingerprint the engine's model."""
    status, body = _get(server, "/health")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["device"] == "cpu"
    want = _fingerprint(resolve_pipeline_config(batch_size=2))
    assert {k: health[k] for k in want} == want
    assert health["backend"] == "torch" and health["model"] == "turbo"
    bare = serve.TranscriptionService(pipelines[1], linger_ms=0.0,
                                      device="cpu")
    assert bare.model_name() == "serve-tiny" and bare.fingerprint == {}


def test_served_srt_equals_the_jax_service(server, pipelines, tmp_path):
    """The same clip through the JAX service (in process) and the port's
    server (JSON path request, SRT response): the same SRT text."""
    from whisperjav_tpu.modules.srt import compose_srt as j_compose
    audio = _clip(5)
    wav = tmp_path / "clip.wav"
    write_wav(wav, audio, SR)
    jsvc = jserve.TranscriptionService(pipelines[0])
    want_subs, _ = jsvc.transcribe_path(str(wav))
    want = j_compose(want_subs)
    assert want.count(" --> ") >= 1
    status, body = _post(server, "/transcribe",
                         json.dumps({"path": str(wav)}).encode())
    assert status == 200
    assert body.decode("utf-8") == want
    # the WAV body gives the same text; the JSON format the same cues
    status, body = _post(server, "/transcribe", wav.read_bytes(),
                         "audio/wav")
    assert status == 200 and body.decode("utf-8") == want
    status, body = _post(server, "/transcribe", json.dumps(
        {"path": str(wav), "format": "json"}).encode())
    payload = json.loads(body)
    assert [(c["start"], c["end"], c["text"]) for c in payload["cues"]] == \
        [(s.start, s.end, s.text) for s in want_subs]
    assert payload["stats"]["coalesced"] is True
    assert payload["stats"]["audio_s"] == pytest.approx(len(audio) / SR,
                                                        abs=1e-3)


def test_unknown_paths_and_missing_files(server, tmp_path):
    assert _http_error(_get, server, "/nope")[0] == 404
    assert _http_error(_post, server, "/nope", b"{}")[0] == 404
    code, body = _http_error(_post, server, "/transcribe", json.dumps(
        {"path": str(tmp_path / "missing.wav")}).encode())
    assert code == 400 and "file not found" in body["error"]
    assert _http_error(_post, server, "/transcribe", b"{}")[0] == 400


def test_a_failing_request_answers_500_and_the_server_lives(server):
    code, body = _http_error(_post, server, "/transcribe", b"not a wav",
                             "audio/wav")
    assert code == 500 and body["error"]
    assert json.loads(_get(server, "/health")[1])["status"] == "ok"


class _Window:
    pass


def test_coalescer_shares_one_engine_pass():
    """Two concurrent requests of two windows each fill the linger cap
    (4 windows at batch size 1): one transcribe_windows pass serves both,
    each gets its own windows back in order. The linger is long, so the
    pass waits for the second request however late it comes."""
    calls = []

    class Engine:
        batch_size = 1

        def transcribe_windows(self, windows, seed=0):
            calls.append(len(windows))
            return [(w, [f"seg-{id(w)}"]) for w in windows]

    co = serve.WindowCoalescer(Engine(), linger_ms=WAIT_S * 1000.0)
    outs = {}

    def client(name):
        wins = [_Window(), _Window()]
        outs[name] = (wins, co.submit(wins))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert calls == [4]
    for wins, result in outs.values():
        assert [w for w, _ in result] == wins
        assert [s for _, segs in result for s in segs] == \
            [f"seg-{id(w)}" for w in wins]


def test_coalescer_propagates_errors():
    class Engine:
        batch_size = 1

        def transcribe_windows(self, windows, seed=0):
            raise RuntimeError("device lost")

    co = serve.WindowCoalescer(Engine(), linger_ms=0.0)
    with pytest.raises(RuntimeError, match="device lost"):
        co.submit([_Window()])
    with pytest.raises(RuntimeError, match="device lost"):
        co.submit([_Window()])          # the worker is still alive


def test_qwen_branch_routes_process_audio():
    """A pipeline without an engine (qwen mode) runs whole under the
    lock, with no coalescer; /health names the fingerprint's model."""
    seen = []

    class QwenPipeline:
        def process_audio(self, audio, rate, title="audio"):
            seen.append((len(audio), rate))
            return ([Subtitle(index=1, start=0.0, end=1.0, text="q")],
                    {"audio_s": len(audio) / rate, "analytics": {}})

    cfg = resolve_pipeline_config(mode="qwen")
    svc = serve.TranscriptionService(QwenPipeline(), device="cpu",
                                     fingerprint=_fingerprint(cfg))
    assert svc.is_qwen and svc.coalescer is None
    subs, stats = svc.transcribe_array(np.zeros(8000, np.float32), 8000)
    assert seen == [(8000, 8000)]        # no resampling on this branch
    assert subs[0].text == "q" and stats["audio_s"] == pytest.approx(1.0)
    assert svc.model_name() == cfg.model


def test_shutdown_endpoint_and_daemon_stop_cli():
    """POST /shutdown ends serve_forever; ``whisperjav-torch
    --daemon-stop`` drives the same endpoint and answers 1 when nothing
    listens."""
    from whisperjav_tpu_torch.cli import main as cli_main

    class QwenPipeline:
        def process_audio(self, audio, rate):
            return [], {}

    svc = serve.TranscriptionService(QwenPipeline(), device="cpu")
    for stop in ("endpoint", "cli"):
        httpd = serve.make_server(svc)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        if stop == "endpoint":
            status, body = _post(port, "/shutdown", b"{}")
            assert json.loads(body) == {"status": "shutting down"}
        else:
            assert cli_main(["--daemon-stop", "--daemon-port",
                             str(port)]) == 0
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
        httpd.server_close()
    assert cli_main(["--daemon-stop", "--daemon-port", str(port)]) == 1


@pytest.mark.parametrize("devices", [["--devices", "2"], ["--devices", "1"],
                                     []])
def test_main_serves_with_devices(monkeypatch, devices):
    """``serve.main`` with ``--devices`` as the JAX server takes it: the
    Whisper pipeline built by the factory with ``devices`` (one device on
    the CPU); /health answers, /shutdown stops it, main returns 0."""
    import whisperjav_tpu_torch.pipelines.factory as factory
    from whisperjav_tpu_torch.models.whisper.weights import (
        init_params as t_init,
    )
    tcfg = TorchWhisperConfig(**_DIMS)
    monkeypatch.setattr(factory, "load_model", lambda *a, **k: (
        tcfg, t_init(tcfg, torch.Generator().manual_seed(0))))
    builds, build = [], factory.build_pipeline

    def spy(*a, **k):
        pipe = build(*a, **k)
        builds.append((k["devices"], pipe.engine.mesh.size))
        return pipe
    monkeypatch.setattr(factory, "build_pipeline", spy)
    health = {}
    make = serve.make_server

    def make_server(service, host, port):
        httpd = make(service, host, 0)

        def drive():
            health.update(json.loads(_get(httpd.server_address[1],
                                          "/health")[1]))
            _post(httpd.server_address[1], "/shutdown", b"{}")
        threading.Thread(target=drive, daemon=True).start()
        return httpd
    monkeypatch.setattr(serve, "make_server", make_server)
    assert serve.main(["--device", "cpu", *devices]) == 0
    want = int(devices[1]) if devices else None
    assert builds == [(want, 1)]
    assert health["status"] == "ok" and health["device"] == "cpu"


def test_main_refuses_devices_with_an_indexed_card(capsys):
    assert serve.main(["--device", "cuda:1", "--devices", "2"]) == 2
    assert "--device cuda:1" in capsys.readouterr().err
