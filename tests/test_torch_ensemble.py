"""The port's two-pass ensemble against the JAX package on the CPU: the
seven merge strategies, the orchestrator (batch-major and serial) at tiny
Whisper widths, its degraded and failed statuses, and the CLI's per-pass
configuration.

Both packages' pipelines are built here from one seeded JAX init per
model name (tiny widths: d=64, 2 + 2 layers, the real vocabulary), f32
on the CPU, with the sensitivity's gates and a single-rung ladder. The
SRTs must match byte for byte and ``ensemble_batch.json`` key for key,
walls aside."""

import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu import cli as jcli
from whisperjav_tpu.ensemble import merge as jmerge
from whisperjav_tpu.ensemble import orchestrator as jorch
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.media_discovery import probe as jprobe
from whisperjav_tpu.modules.srt import Subtitle as JSub
from whisperjav_tpu_torch import cli as tcli
from whisperjav_tpu_torch.ensemble import merge as tmerge
from whisperjav_tpu_torch.ensemble import orchestrator as torch_orch
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.modules.media_discovery import probe as tprobe
from whisperjav_tpu_torch.modules.srt import Subtitle as TSub
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

_DIMS = dict(name="ensemble-tiny", n_mels=128, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51866)
TINY, TTINY = WhisperConfig(**_DIMS), TWhisperConfig(**_DIMS)
SR = 16000
_WEIGHTS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech_like(duration_s, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * (150 + 20 * seed) * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def short_wavs(tmp_path, n=2):
    """``n`` clips of 1 s silence, ~5 s of speech-like sound, 1 s silence."""
    gap = np.zeros(SR, np.float32)
    paths = []
    for i in range(n):
        path = tmp_path / f"clip{i}.wav"
        write_wav(path, np.concatenate([gap, speech_like(5 + i, i), gap]),
                  SR)
        paths.append(path)
    return paths


def _weights(model_name):
    """One seeded JAX init per model name (both packages share it)."""
    if model_name not in _WEIGHTS:
        params = init_params(TINY, jax.random.PRNGKey(
            zlib.crc32(model_name.encode()) % 1000))
        _WEIGHTS[model_name] = params
    return _WEIGHTS[model_name]


def _options(cfg, decode_mod):
    sens = cfg.sensitivity
    return decode_mod.DecodeOptions(
        task=cfg.task, language=cfg.language,
        with_timestamps=cfg.mode.with_timestamps and not cfg.no_timestamps,
        repetition_penalty=sens.repetition_penalty,
        no_repeat_ngram_size=sens.no_repeat_ngram_size,
        beam_size=sens.beam_size, patience=sens.patience,
        best_of=sens.best_of, cross_kv_int8=True)


def _vad_kwargs(cfg):
    sens = cfg.sensitivity
    out = dict(cfg.vad_kwargs)
    if cfg.mode.vad_backend == "energy":
        out.setdefault("energy_db", sens.energy_vad_db)
    else:
        out.setdefault("threshold", sens.vad_threshold)
    out.setdefault("max_group_duration_s", sens.max_group_duration_s)
    return out


def jax_pipeline(cfg, postprocessor=None, tracer=None):
    """The JAX package's file pipeline for ``cfg`` at the tiny widths."""
    from whisperjav_tpu.models.whisper import decode as jd
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu.pipelines.transcribe import TranscribePipeline
    sens = cfg.sensitivity
    engine = je.TranscriptionEngine(
        TINY, _weights(cfg.model), options=_options(cfg, jd),
        thresholds=je.QualityThresholds(
            logprob_threshold=sens.logprob_threshold,
            no_speech_threshold=sens.no_speech_threshold,
            temperatures=(0.0,)),
        batch_size=cfg.batch_size, mesh=None, compute_dtype=jnp.float32)
    return TranscribePipeline(
        engine, scene_backend=cfg.mode.scene_backend,
        vad_backend=cfg.mode.vad_backend, scene_kwargs=cfg.scene_kwargs,
        vad_kwargs=_vad_kwargs(cfg), language=cfg.language,
        postprocessor=postprocessor, tracer=tracer, pack=cfg.pack_windows)


def torch_pipeline(cfg, postprocessor=None, tracer=None):
    """The port's file pipeline for ``cfg`` on the same weights."""
    from whisperjav_tpu_torch.models.whisper import decode as td
    from whisperjav_tpu_torch.pipelines import engine as te
    from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline
    sens = cfg.sensitivity
    model = params_from_jax(jax.tree.map(np.asarray, _weights(cfg.model)),
                            TTINY)
    engine = te.TranscriptionEngine(
        TTINY, model, options=_options(cfg, td),
        thresholds=te.QualityThresholds(
            logprob_threshold=sens.logprob_threshold,
            no_speech_threshold=sens.no_speech_threshold,
            temperatures=(0.0,)),
        batch_size=cfg.batch_size, device="cpu",
        compute_dtype=torch.float32)
    return TranscribePipeline(
        engine, scene_backend=cfg.mode.scene_backend,
        vad_backend=cfg.mode.vad_backend, scene_kwargs=cfg.scene_kwargs,
        vad_kwargs=_vad_kwargs(cfg), language=cfg.language,
        postprocessor=postprocessor, tracer=tracer, pack=cfg.pack_windows)


def tiny_builders(monkeypatch):
    """Both packages' ``factory.build_pipeline`` build the tiny f32
    pipelines above (the CLIs import it at call time)."""
    from whisperjav_tpu.pipelines import factory as jf
    from whisperjav_tpu_torch.pipelines import factory as tf
    monkeypatch.setattr(jf, "build_pipeline",
                        lambda cfg, checkpoint=None, postprocessor=None,
                        tracer=None, **_: jax_pipeline(cfg, postprocessor,
                                                       tracer))
    monkeypatch.setattr(tf, "build_pipeline",
                        lambda cfg, checkpoint=None, postprocessor=None,
                        device="cpu", tracer=None, **_: torch_pipeline(
                            cfg, postprocessor, tracer))


# ---------------------------------------------------------------------------
# merge strategies
# ---------------------------------------------------------------------------

def _cues(rng, n, jitter_from=None):
    kana = "あいうえおかきくけこさしすせそたちつてと"
    out = []
    if jitter_from is not None:
        for s in jitter_from:
            if rng.uniform() < 0.3:
                continue
            a = s[0] + rng.normal(0, 0.4)
            text = s[2] if rng.uniform() < 0.3 else "".join(
                rng.choice(list(kana), int(rng.integers(1, 30))))
            out.append((max(a, 0.0), max(a, 0.0) + rng.uniform(0.3, 4.0),
                        text))
    t = 0.0
    for _ in range(n):
        t += rng.uniform(0.0, 3.0)
        d = rng.uniform(0.2, 5.0)
        out.append((t, t + d, "".join(
            rng.choice(list(kana), int(rng.integers(0, 40))))))
        t += d * rng.uniform(0.2, 1.2)
    out.sort()
    return [(round(a, 3), round(b, 3), c) for a, b, c in out]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy", sorted(jmerge.MERGE_STRATEGIES))
def test_merge_strategies_match_jax(strategy, seed):
    assert sorted(tmerge.MERGE_STRATEGIES) == sorted(jmerge.MERGE_STRATEGIES)
    rng = np.random.default_rng(seed)
    p1 = _cues(rng, 18)
    p2 = _cues(rng, 6, jitter_from=p1)
    got, gstats = tmerge.MergeEngine(strategy).merge(
        [TSub(i + 1, *c) for i, c in enumerate(p1)],
        [TSub(i + 1, *c) for i, c in enumerate(p2)])
    want, wstats = jmerge.MergeEngine(strategy).merge(
        [JSub(i + 1, *c) for i, c in enumerate(p1)],
        [JSub(i + 1, *c) for i, c in enumerate(p2)])
    assert [(s.index, s.start, s.end, s.text) for s in got] == \
        [(s.index, s.start, s.end, s.text) for s in want]
    assert gstats.to_dict() == wstats.to_dict()
    assert len(got) >= 1


def test_unknown_merge_strategy_raises():
    with pytest.raises(ValueError, match="unknown merge strategy"):
        tmerge.MergeEngine("best")


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------

def _pass_configs(presets):
    return (presets.resolve_pipeline_config(mode="balanced",
                                            sensitivity="balanced",
                                            batch_size=2),
            presets.resolve_pipeline_config(mode="fidelity",
                                            sensitivity="aggressive",
                                            batch_size=2,
                                            enhancer_backend="none"))


def _summary_without_walls(path, tmp_dir):
    s = json.loads(path.read_text(encoding="utf-8"))
    s.pop("wall_s")
    return json.loads(json.dumps(s).replace(str(tmp_dir), "<d>"))


@pytest.mark.parametrize("serial", [False, True],
                         ids=["batch-major", "serial"])
def test_orchestrator_matches_jax(tmp_path, serial):
    """Two passes (balanced turbo-named weights, then fidelity-named
    weights at aggressive) over two clips, smart_merge, the sanitizer
    after the merge: the same SRTs and summary as the JAX orchestrator."""
    from whisperjav_tpu.config import presets as jp
    from whisperjav_tpu.modules.sanitize import SRTPostProcessor as JPost
    from whisperjav_tpu_torch.config import presets as tp
    from whisperjav_tpu_torch.modules.sanitize import (
        SRTPostProcessor as TPost,
    )
    wavs = short_wavs(tmp_path)

    class J(jorch.EnsembleOrchestrator):
        def _build(self, cfg):
            return jax_pipeline(cfg)

    class T(torch_orch.EnsembleOrchestrator):
        def _build(self, cfg):
            return torch_pipeline(cfg)

    out = {}
    for side, cls, presets, post, probe in (
            ("jax", J, jp, JPost, jprobe), ("torch", T, tp, TPost, tprobe)):
        c1, c2 = _pass_configs(presets)
        kw = {"device": "cpu"} if side == "torch" else {}
        summary = cls(c1, c2, merge_strategy="smart_merge",
                      postprocessor=post(), serial_mode=serial,
                      **kw).process_batch([probe(w) for w in wavs],
                                          tmp_path / side)
        assert summary["ok"] == 2
        out[side] = (_summary_without_walls(
            tmp_path / side / "ensemble_batch.json", tmp_path / side),
            [(tmp_path / side / f"clip{i}.ja.whisperjav.srt").read_bytes()
             for i in range(2)])
    assert out["torch"] == out["jax"]
    assert sum(r["merge"]["merged_cues"]
               for r in out["torch"][0]["results"]) >= 1


class _Stub:
    """A pipeline whose ``process_audio`` gives one cue, or raises."""

    def __init__(self, sub_cls, fail):
        self.sub_cls, self.fail = sub_cls, fail

    def process_audio(self, audio, sample_rate):
        if self.fail:
            raise RuntimeError("device lost")
        return [self.sub_cls(1, 0.5, 1.5, "テスト")], {}


@pytest.mark.parametrize("fail", ["pass1", "pass2", "pass2-build"])
@pytest.mark.parametrize("serial", [False, True],
                         ids=["batch-major", "serial"])
def test_orchestrator_failure_statuses_match_jax(tmp_path, fail, serial):
    """Pass-2 failure degrades to pass 1's cues ('degraded'), pass-1
    failure is 'failed', in both packages, with the same summary."""
    from whisperjav_tpu.config import presets as jp
    from whisperjav_tpu_torch.config import presets as tp
    wavs = short_wavs(tmp_path, 1)
    out = {}
    for side, base, presets, sub, probe in (
            ("jax", jorch.EnsembleOrchestrator, jp, JSub, jprobe),
            ("torch", torch_orch.EnsembleOrchestrator, tp, TSub, tprobe)):

        class O(base):
            def _build(self, cfg):
                second = cfg is self.pass2_cfg
                if fail == "pass2-build" and second:
                    raise RuntimeError("out of memory")
                return _Stub(sub, fail == ("pass2" if second else "pass1"))

        c1, c2 = _pass_configs(presets)
        O(c1, c2, serial_mode=serial).process_batch(
            [probe(w) for w in wavs], tmp_path / side)
        out[side] = _summary_without_walls(
            tmp_path / side / "ensemble_batch.json", tmp_path / side)
    assert out["torch"] == out["jax"]
    status = out["torch"]["results"][0]["status"]
    assert status == ("failed" if fail == "pass1" else "degraded")


def test_orchestrator_drops_pass1_before_pass2(tmp_path):
    """Batch-major order: pass 1's pipeline is gone (garbage-collected)
    when pass 2 is built."""
    import gc
    import weakref
    from whisperjav_tpu_torch.config import presets as tp
    wavs = short_wavs(tmp_path, 1)
    refs = []

    class O(torch_orch.EnsembleOrchestrator):
        def _build(self, cfg):
            gc.collect()
            alive = [r() is not None for r in refs]
            p = _Stub(TSub, False)
            p.cycle = p          # a cycle only the collector frees
            refs.append(weakref.ref(p))
            self.alive_at_build = alive
            return p

    c1, c2 = _pass_configs(tp)
    orch = O(c1, c2, device="cpu")
    orch.process_batch([tprobe(w) for w in wavs], tmp_path)
    assert orch.alive_at_build == [False]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.mark.parametrize("flags", [
    [],
    ["--pass1-mode", "balanced", "--pass2-mode", "fidelity",
     "--merge-strategy", "longest"],
    ["--mode", "faster", "--pass1-model", "small", "--pass2-model",
     "medium", "--pass1-vad-threshold", "0.3", "--pass2-speech-segmenter",
     "energy", "--pass2-scene-detector", "none", "--pass1-speech-pad-ms",
     "150", "--pass2-speech-enhancer", "zipenhancer",
     "--pass2-enhance-for-vad"],
    ["--pass1-sensitivity", "conservative", "--pass2-sensitivity",
     "balanced", "--pass1-overrides", "sensitivity.beam_size=3",
     "--pass2-params", '{"batch_size": 4}', "--overrides",
     "sensitivity.patience=2.0", "--beam-size", "4"],
    ["--pass2-mode", "transformers", "--pass2-hf-params",
     '{"chunk_s": 20.0}', "--pass1-qwen-params", '{"batch_size": 3}',
     "--ensemble-serial"],
], ids=["defaults", "modes", "per-pass-flags", "overrides", "json-params"])
def test_cli_resolves_the_pass_configs_as_the_jax_cli(tmp_path, monkeypatch,
                                                      flags):
    """``--ensemble`` with the ``--pass{1,2}-*`` flags: the orchestrator of
    each package receives the same two configs, merge strategy and serial
    mode."""
    wav = short_wavs(tmp_path, 1)[0]
    seen = {}

    def capture(side):
        def init(self, c1, c2, merge_strategy="smart_merge",
                 serial_mode=False, **kw):
            seen[side] = (dataclasses.asdict(c1), dataclasses.asdict(c2),
                          merge_strategy, serial_mode)
            raise _Captured
        return init

    monkeypatch.setattr(jorch.EnsembleOrchestrator, "__init__",
                        capture("jax"))
    monkeypatch.setattr(torch_orch.EnsembleOrchestrator, "__init__",
                        capture("torch"))
    argv = [str(wav), "--ensemble", "--output-dir", str(tmp_path / "o"),
            *flags]
    for side, mod in (("jax", jcli), ("torch", tcli)):
        with pytest.raises(_Captured):
            mod.main(list(argv))
    assert json.dumps(seen["torch"], sort_keys=True, default=str) == \
        json.dumps(seen["jax"], sort_keys=True, default=str)
    assert seen["torch"][1]["sensitivity"]["name"] == (
        "balanced" if "--pass2-sensitivity" in flags else "aggressive")
