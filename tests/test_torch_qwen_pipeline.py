"""The port's Qwen pipeline vs the JAX package on the CPU: the whole
``QwenPipeline.process`` (semantic scenes, safe chunking, the whisperseg
framer, the Qwen3-ASR generator at the test widths on the JAX
generator's own loaded weights (fused q/k/v, int8 LM quantised under
jit), the forced aligner on the JAX aligner's weights, step-down
retries, hardening, regrouping, stitching, the light sanitise and
analytics) writes the same SRT byte for byte and metadata with the same
keys, pooled across scenes and scene by scene; and the port's CLI runs
``--mode qwen`` end to end."""

import json

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.models.qwen.aligner import ForcedAligner as JaxAligner
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.media_discovery import probe as jax_probe
from whisperjav_tpu.modules.subtitle_pipeline import components as jc
from whisperjav_tpu.modules.subtitle_pipeline.orchestrator import (
    DecoupledSubtitlePipeline as JaxDecoupled,
)
from whisperjav_tpu.modules.subtitle_pipeline.types import (
    StepDownConfig as JaxStepDown,
)
from whisperjav_tpu.pipelines.qwen import QwenPipeline as JaxQwenPipeline
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.models.qwen import aligner as ta
from whisperjav_tpu_torch.models.qwen.model import QWEN_SIZES
from whisperjav_tpu_torch.models.qwen.weights import params_from_jax
from whisperjav_tpu_torch.modules.media_discovery import probe
from whisperjav_tpu_torch.modules.srt import load_srt
from whisperjav_tpu_torch.modules.subtitle_pipeline import components as tc
from whisperjav_tpu_torch.modules.subtitle_pipeline.orchestrator import (
    DecoupledSubtitlePipeline,
)
from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    StepDownConfig,
)
from whisperjav_tpu_torch.pipelines.qwen import QwenPipeline
from whisperjav_tpu_torch.pipelines.qwen_factory import build_qwen_pipeline
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech_like(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * (160 + 15 * seed) * t) \
        * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def write_clip(path, seconds, seed=0):
    """Speech-like bursts (2-7 s) between silences (0.6-2.5 s)."""
    rng = np.random.default_rng(seed)
    parts, total, k = [], 0.0, 0
    while total < seconds:
        sp, gap = float(rng.uniform(2, 7)), float(rng.uniform(0.6, 2.5))
        parts += [speech_like(sp, k), np.zeros(int(gap * SR), np.float32)]
        total += sp + gap
        k += 1
    audio = np.concatenate(parts)
    write_wav(path, audio, SR)
    return len(audio) / SR


@pytest.fixture(scope="module")
def weights():
    """The JAX generator's loaded weights (random init, fused, int8 under
    jit) and the JAX aligner's, and the port's copies of both."""
    jgen = jc.QwenGenerator(model_size="qwen3-asr-test", batch_size=4)
    jgen.load()
    jal = JaxAligner()
    tparams = params_from_jax(jax.tree.map(np.asarray, jgen._params),
                              QWEN_SIZES["qwen3-asr-test"])
    taparams = ta.params_from_jax(jax.tree.map(np.asarray, jal.params),
                                  ta.AlignerConfig())
    return jgen._params, jal, tparams, taparams


def _jax_pipeline(weights, pooled, monkeypatch):
    jparams, jal, _, _ = weights
    monkeypatch.setenv("WJAV_POOL_SCENES", "1" if pooled else "0")
    gen = jc.QwenGenerator(model_size="qwen3-asr-test", batch_size=4,
                           params=jparams)
    decoupled = JaxDecoupled(
        framer=jc.VadGroupedFramer(vad_backend="whisperseg"), generator=gen,
        cleaner=jc.PassthroughCleaner(),
        aligner=jc.QwenAlignerAdapter(aligner=jal), max_group_s=6.0,
        step_down=JaxStepDown(enabled=True))
    return JaxQwenPipeline(decoupled, scene_backend="semantic")


def _torch_pipeline(weights, pooled=None):
    """The port's pipeline; ``pooled`` None leaves pooling to
    ``WJAV_POOL_SCENES``, as the JAX pipeline always does."""
    _, _, tparams, taparams = weights
    gen = tc.QwenGenerator(model_size="qwen3-asr-test", batch_size=4,
                           params=tparams, device="cpu")
    decoupled = DecoupledSubtitlePipeline(
        framer=tc.VadGroupedFramer(vad_backend="whisperseg"), generator=gen,
        cleaner=tc.PassthroughCleaner(),
        aligner=tc.QwenAlignerAdapter(
            aligner=ta.ForcedAligner(params=taparams, device="cpu"),
            device="cpu"),
        max_group_s=6.0, step_down=StepDownConfig(enabled=True),
        pool_scenes=pooled)
    return QwenPipeline(decoupled, scene_backend="semantic", device="cpu")


def _keys(tree):
    """The nested key structure of a JSON value (lists by their first
    item)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(tree[0])] if tree else []
    return type(tree).__name__ if isinstance(tree, (bool, str)) else "num"


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled",
                                                      "per-scene"])
def test_qwen_pipeline_srt_identical(tmp_path, weights, pooled,
                                     monkeypatch):
    """A ~55 s clip: semantic scenes clamped to 12-48 s give at least two
    scenes; the SRT is the JAX package's byte for byte."""
    wav = tmp_path / "clip.wav"
    duration = write_clip(wav, 52.0)
    assert duration > 48.0
    want = _jax_pipeline(weights, pooled, monkeypatch).process(
        jax_probe(wav), tmp_path / "jax")
    # WJAV_POOL_SCENES as the JAX pipeline was given it, no argument
    got = _torch_pipeline(weights).process(probe(wav), tmp_path / "torch")
    assert got.srt_path.name == want.srt_path.name == "clip.ja.whisperjav.srt"
    srt = got.srt_path.read_text(encoding="utf-8")
    assert srt == want.srt_path.read_text(encoding="utf-8")
    assert srt.count("-->") >= 2
    meta = {side: json.loads((tmp_path / side / "clip.whisperjav.json")
                             .read_text(encoding="utf-8"))
            for side in ("jax", "torch")}
    assert _keys(meta["torch"]) == _keys(meta["jax"])
    m = meta["torch"]
    assert m["pipeline"] == "qwen" and m["scenes"] >= 2
    assert m["scenes"] == meta["jax"]["scenes"]
    for k in ("analytics",):
        assert m[k] == meta["jax"][k]
    strip = ("elapsed_s", "stage_s")
    assert [{k: v for k, v in d.items() if k not in strip}
            for d in m["scene_diagnostics"]] == \
        [{k: v for k, v in d.items() if k not in strip}
         for d in meta["jax"]["scene_diagnostics"]]
    assert set(m["stats"]["stage_s"]) == {
        "scenes", "enhance", "frame", "generate", "clean", "align",
        "assemble", "extract"}
    assert m["stats"]["e2e_rtf_x"] > 0
    for s in load_srt(got.srt_path):
        assert 0.0 <= s.start <= s.end <= duration


class _Resident:
    def load(self): ...

    def unload(self): ...


@pytest.mark.parametrize("env,arg,want", [
    (None, None, "pooled"), ("1", None, "pooled"), ("0", None, "scene"),
    ("0", True, "pooled"), (None, False, "scene")])
def test_pool_scenes_environment_and_argument(monkeypatch, env, arg, want):
    """``WJAV_POOL_SCENES`` read on each ``process_scenes`` call, as the
    JAX orchestrator reads it; an explicit ``pool_scenes`` wins."""
    if env is None:
        monkeypatch.delenv("WJAV_POOL_SCENES", raising=False)
    else:
        monkeypatch.setenv("WJAV_POOL_SCENES", env)
    scenes = [np.zeros(SR, np.float32)] * 2
    routes = []
    for cls, kw in ((JaxDecoupled, {}),
                    (DecoupledSubtitlePipeline, {"pool_scenes": arg})):
        pipe = cls(framer=None, generator=_Resident(), cleaner=None,
                   aligner=_Resident(), **kw)
        pipe._process_scenes_pooled = lambda audios, sr: ["pooled"]
        pipe._process_scene = lambda si, audio, sr: "scene"
        routes.append(pipe.process_scenes(scenes, SR)[0])
    jax_route, port_route = routes
    assert port_route == want
    if arg is None:
        assert port_route == jax_route


def test_qwen_factory_default_stack():
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    cfg = resolve_pipeline_config(mode="qwen")
    pipe = build_qwen_pipeline(cfg, device="cpu")
    dec = pipe.decoupled
    assert dec.generator.cfg.name == "qwen3-asr-1.7b"
    assert dec.generator.batch_size == cfg.batch_size == 32
    assert dec.framer.vad_backend == "whisperseg"
    assert pipe.scene_detector.name == "semantic"
    assert dec.aligner.name == "qwen3" and dec.step_down.enabled
    assert dec.generator.device.type == dec.aligner.device.type == "cpu"


def test_qwen_pipeline_process_audio_stats(weights):
    """``process_audio`` (the resident-engine entry) returns the cues and
    the stats the metadata is built from."""
    audio = np.concatenate([speech_like(4, 1), np.zeros(SR, np.float32),
                            speech_like(3, 2)])
    subs, stats = _torch_pipeline(weights, True).process_audio(
        audio, SR, title="mem")
    assert stats["scenes"] == 1 and stats["windows"] >= 1
    assert {"e2e_wall_s", "e2e_rtf_x", "stage_s", "final_subtitles",
            "analytics", "scene_diagnostics"} <= set(stats)
    assert stats["final_subtitles"] == len(subs)


def test_cohere_generator_matches_jax(weights):
    """The cohere slot (greedy, no penalty, overlapped chunks joined by
    their longest repeated suffix/prefix) on the JAX generator's weights:
    the same texts and log-probabilities."""
    jparams, _, tparams, _ = weights
    kw = dict(model_size="qwen3-asr-test", batch_size=4, chunk_s=4.0,
              overlap_s=1.0, max_new_tokens=24)
    jg = jc.CohereStyleGenerator(**kw)
    tg = tc.CohereStyleGenerator(device="cpu", **kw)
    jg._inner._params, tg._inner._params = jparams, tparams
    clips = [speech_like(9.5, 1), speech_like(3.0, 2), speech_like(4.5, 3)]
    got, want = tg.generate_batch(clips, SR), jg.generate_batch(clips, SR)
    assert [(r.frame_index, r.text) for r in got] \
        == [(r.frame_index, r.text) for r in want]
    np.testing.assert_allclose([r.avg_logprob for r in got],
                               [r.avg_logprob for r in want], atol=1e-4)
    for a, b in (("あいうえお", "えおかき"), ("", "x"), ("abc", "")):
        assert tc.CohereStyleGenerator._join_overlapped(a, b) \
            == jc.CohereStyleGenerator._join_overlapped(a, b)


_CPU_QWEN = ["--mode", "qwen", "--device", "cpu", "--qwen-model-id",
             "qwen3-asr-test", "--qwen-batch-size", "4", "--no-signature"]


@pytest.mark.parametrize("flags,aligned", [
    (["--qwen-timestamps", "none"], False),
    (["--context", "字幕", "--qwen-max-tokens", "40", "--timestamp-mode",
      "aligner_interpolation", "--no-qwen-safe-chunking"], True),
    (["--generator", "cohere", "--generator-config",
      '{"chunk_s": 4.0, "overlap_s": 1.0}', "--qwen-max-tokens", "24",
      "--framer", "full-scene", "--cleaner", "assembly"], True),
    (["--context-file", "{ctx}", "--no-step-down", "--regroup-mode",
      "sentence_only", "--qwen-max-tokens-per-second", "6"], True),
], ids=["timestamps-none", "context-and-budget", "cohere-full-scene",
        "context-file"])
def test_cli_qwen_mode(tmp_path, flags, aligned):
    ctx = tmp_path / "context.txt"
    ctx.write_text("登場人物: 田中\n", encoding="utf-8")
    flags = [f.replace("{ctx}", str(ctx)) for f in flags]
    wav = tmp_path / "clip.wav"
    duration = write_clip(wav, 14.0, seed=3)
    out = tmp_path / "out"
    assert cli.main([str(wav), "--output-dir", str(out), *_CPU_QWEN,
                     *flags]) == 0
    cues = load_srt(out / "clip.ja.whisperjav.srt")
    meta = json.loads((out / "clip.whisperjav.json").read_text())
    assert meta["pipeline"] == "qwen" and meta["scenes"] == 1
    assert cues and all(0 <= c.start <= c.end <= duration + 1e-3
                        for c in cues)
    am = meta["analytics"]["alignment_metrics"]
    if aligned:
        assert am["null_timestamp_words"] == 0
    else:       # NullAligner: every word null-stamped, hardening places it
        assert am["null_timestamp_words"] == am["aligned_words"] > 0


def test_cli_qwen_anime_whisper_generator(tmp_path):
    """``--generator anime-whisper``: a Whisper model (tiny, seeded random
    init) in the generator slot through the port's engine."""
    wav = tmp_path / "clip.wav"
    duration = write_clip(wav, 9.0, seed=5)
    out = tmp_path / "out"
    assert cli.main([str(wav), "--output-dir", str(out), "--mode", "qwen",
                     "--device", "cpu", "--generator", "anime-whisper",
                     "--model", "tiny", "--qwen-batch-size", "2",
                     "--no-signature"]) == 0
    meta = json.loads((out / "clip.whisperjav.json").read_text())
    assert meta["pipeline"] == "qwen" and meta["stats"]["windows"] >= 1
    for c in load_srt(out / "clip.ja.whisperjav.srt"):
        assert 0 <= c.start <= c.end <= duration + 1e-3


def test_cli_qwen_dump_params(capsys):
    assert cli.main(["x.wav", "--mode", "qwen", "--dump-params"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["model"] == "qwen3-asr-1.7b" and d["batch_size"] == 32
    assert d["mode"]["scene_backend"] == "semantic"
    assert d["mode"]["vad_backend"] == "whisperseg"
    assert d["device"] == "cuda"
