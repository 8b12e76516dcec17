"""The slice as a whole: the port's file pipeline writes the same SRT as the
JAX pipeline on the same weights (tiny model, f32 on the CPU), with bf16
and with int8 decoder weights; the port's CLI runs the modes and flags it
covers, resolves them as the JAX CLI does, and refuses what it does not
cover."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.config.presets import resolve_pipeline_config
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.media_discovery import probe
from whisperjav_tpu.modules.sanitize import SRTPostProcessor
from whisperjav_tpu.modules.srt import load_srt
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.modules.media_discovery import probe as torch_probe
from whisperjav_tpu_torch.modules.sanitize import (
    SRTPostProcessor as TorchSRTPostProcessor,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="torch-e2e-tiny", n_mels=128, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51866)
TINY = WhisperConfig(**_DIMS)          # the JAX package's
TTINY = TorchWhisperConfig(**_DIMS)    # the port's
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech_like(duration_s, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _wav(tmp_path, name="clip.wav"):
    gap = np.zeros(3 * SR, np.float32)
    audio = np.concatenate([speech_like(20, 0), gap, speech_like(20, 1), gap,
                            speech_like(20, 2)])
    path = tmp_path / name
    write_wav(path, audio, SR)
    return path


def _jax_pipeline(cfg, params, thresholds, options, int8_weights):
    from whisperjav_tpu.pipelines.engine import TranscriptionEngine
    from whisperjav_tpu.pipelines.transcribe import TranscribePipeline
    engine = TranscriptionEngine(TINY, params, options=options,
                                 thresholds=thresholds,
                                 batch_size=cfg.batch_size, mesh=None,
                                 compute_dtype=jnp.float32,
                                 int8_weights=int8_weights)
    return TranscribePipeline(engine, scene_backend=cfg.mode.scene_backend,
                              vad_backend=cfg.mode.vad_backend,
                              vad_kwargs=_vad_kwargs(cfg),
                              postprocessor=SRTPostProcessor(),
                              keep_intermediates=True)


def _vad_kwargs(cfg):
    return {"threshold": cfg.sensitivity.vad_threshold,
            "max_group_duration_s": cfg.sensitivity.max_group_duration_s}


@pytest.mark.parametrize("int8_weights", [False, True])
def test_port_pipeline_writes_the_jax_srt(tmp_path, int8_weights):
    from whisperjav_tpu.models.whisper import decode as jd
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu_torch.models.whisper import decode as td
    from whisperjav_tpu_torch.pipelines import engine as te
    from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline

    cfg = resolve_pipeline_config(mode="balanced", sensitivity="balanced",
                                  batch_size=4)
    sens = cfg.sensitivity
    assert (cfg.mode.scene_backend, cfg.mode.vad_backend) == \
        ("energy", "silero")
    common = dict(repetition_penalty=sens.repetition_penalty,
                  no_repeat_ngram_size=sens.no_repeat_ngram_size,
                  beam_size=sens.beam_size, patience=sens.patience,
                  best_of=sens.best_of, cross_kv_int8=True)
    # the balanced gates with a single-rung ladder (t=0 beam search only)
    gates = dict(logprob_threshold=sens.logprob_threshold,
                 no_speech_threshold=sens.no_speech_threshold,
                 temperatures=(0.0,))
    params = init_params(TINY, jax.random.PRNGKey(7))
    model = params_from_jax(jax.tree.map(np.asarray, params), TTINY)

    wav = _wav(tmp_path)
    ref = _jax_pipeline(cfg, params, je.QualityThresholds(**gates),
                        jd.DecodeOptions(**common), int8_weights).process(
        probe(wav), tmp_path / "jax")
    engine = te.TranscriptionEngine(
        TTINY, model, options=td.DecodeOptions(**common),
        thresholds=te.QualityThresholds(**gates), batch_size=4,
        device="cpu", compute_dtype=torch.float32,
        int8_weights=int8_weights)
    assert hasattr(engine.model.decoder, "lm_head_q") == int8_weights
    out = TranscribePipeline(engine, vad_backend="silero",
                             vad_kwargs=_vad_kwargs(cfg),
                             postprocessor=TorchSRTPostProcessor(),
                             keep_intermediates=True).process(
        torch_probe(wav), tmp_path / "torch")

    assert out.srt_path.name == ref.srt_path.name == "clip.ja.whisperjav.srt"
    # several packed windows in one batch, each with decoded text
    assert ref.metadata["stats"]["windows"] >= 2
    assert ref.metadata["stats"]["raw_subtitles"] >= 2
    for key in ("windows", "scenes", "groups", "raw_subtitles",
                "final_subtitles"):
        assert out.metadata["stats"][key] == ref.metadata["stats"][key], key
    # the SRT before and after the sanitizer, cue for cue and byte for byte
    for name in ("clip.ja.whisperjav.raw.srt", "clip.ja.whisperjav.srt"):
        got, want = tmp_path / "torch" / name, tmp_path / "jax" / name
        assert [(s.start, s.end, s.text) for s in load_srt(got)] == \
            [(s.start, s.end, s.text) for s in load_srt(want)]
        assert got.read_text(encoding="utf-8") == \
            want.read_text(encoding="utf-8")
    diag = {side: json.loads((tmp_path / side / "clip.transcribe.json")
                             .read_text())["windows"]
            for side in ("jax", "torch")}
    assert [(w["start"], w["segments"], w["chars"]) for w in diag["torch"]] \
        == [(w["start"], w["segments"], w["chars"]) for w in diag["jax"]]


@pytest.mark.parametrize("flags", [
    ["--ensemble"], ["--daemon", "--devices", "2"], ["--check"],
    ["--multihost", "--devices", "2"],
    ["--async-processing"], ["--translate", "ollama"],
    ["--daemon", "--ensemble"], ["--check-verbose"],
    ["--mode", "transformers", "--devices", "8"],
    ["--devices", "4"],
    ["--trace-params", "trace.jsonl"],
    ["--mode", "qwen", "--ensemble"],
    ["--mode", "qwen", "--multihost", "--ensemble"],
    ["--mode", "qwen", "--translate", "ollama"],
])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, flags):
    assert cli.main([str(tmp_path / "clip.wav"), *flags]) == 2
    assert "not ported yet" in capsys.readouterr().err


# the qwen-mode CPU run: the test-width Qwen3-ASR
_QWEN_CPU_RUN = ["--device", "cpu", "--qwen-model-id", "qwen3-asr-test",
                 "--qwen-batch-size", "2"]


@pytest.mark.parametrize("flags,backend,engines", [
    (["--enhancer", "bs-roformer", "--enhancer-weights", "{bsr}",
      "--enhancer-arg", "chunk_s=1", "--enhancer-arg", "crossfade_s=0.1"],
     "bs-roformer", ["bs_roformer"]),
    (["--mode", "qwen", "--qwen-enhancer", "bs-roformer"], "bs-roformer",
     []),
    (["--enhancer", "clearvoice", "--enhancer-weights", "{mf2}"],
     "clearvoice", ["mossformer2"]),
    # --qwen-enhancer-model does not reach the enhancer (as in the JAX
    # CLI): the backend passes audio through
    (["--mode", "qwen", "--qwen-enhancer", "clearvoice",
      "--qwen-enhancer-model", "{mf2}"], "clearvoice", []),
    (["--mode", "fidelity", "--enhancer", "vocals"], "bs-roformer", []),
    (["--enhancer", "mossformer", "--enhancer-weights", "{frcrn}",
      "--enhancer-arg", "model=FRCRN_SE_16K"], "clearvoice", ["frcrn"]),
])
def test_cli_runs_the_heavy_enhancers(tmp_path, flags, backend, engines):
    """The heavy enhancers and their aliases through the CLI on the CPU
    (test widths, seeded weights written by the port): exit 0, and the
    metadata names the backend and the network that enhanced each scene
    (none without weights)."""
    from whisperjav_tpu_torch.models.enhancement import (
        bs_roformer, frcrn, mossformer2,
    )
    gen = torch.Generator().manual_seed(0)
    files = {"bsr": (bs_roformer, bs_roformer.BSR_TEST),
             "mf2": (mossformer2, mossformer2.MF2_TEST),
             "frcrn": (frcrn, frcrn.FRCRN_TEST)}
    for key, (module, cfg) in files.items():
        if any(f"{{{key}}}" in f for f in flags):
            path = str(tmp_path / f"{key}.npz")
            module.save_params(path, module.init_params(cfg, gen))
            flags = [f.replace(f"{{{key}}}", path) for f in flags]
    qwen = "qwen" in flags
    wav = _short_wav(tmp_path)
    assert cli.main([str(wav), "--output-dir", str(tmp_path / "out"),
                     *(_QWEN_CPU_RUN if qwen else _CPU_RUN), *flags]) == 0
    stats = json.loads((tmp_path / "out" / "short.whisperjav.json")
                       .read_text())["stats"]
    assert stats["enhancer"] == {"backend": backend, "engines": engines}
    assert stats["enhanced_scenes"] == (stats["scenes"] if engines else 0)
    if engines:
        assert stats["scenes"] >= 1


def _short_wav(tmp_path):
    gap = np.zeros(SR, np.float32)
    path = tmp_path / "short.wav"
    write_wav(path, np.concatenate([gap, speech_like(5, 3), gap]), SR)
    return path


# the CPU run of each: the tiny model from its seeded init, one window a
# batch, beam 2, a logprob gate every row passes (no ladder rungs), a
# 7 s clip (the 448-frame bucket: 144 new tokens at most)
_CPU_RUN = ["--device", "cpu", "--model", "tiny", "--batch-size", "1",
            "--logprob-threshold", "-100"]


@pytest.mark.parametrize("flags,want", [
    (["--mode", "fidelity", "--enhancer-weights", "{zip}"],
     {"scene_backend": "energy", "enhanced_scenes": "scenes"}),
    (["--mode", "transformers", "--hf-chunk-length", "4", "--hf-stride",
      "1", "--hf-batch-size", "2"], {"scene_backend": "chunked",
                                     "windows": 2}),
    (["--mode", "anime"], {"scene_backend": "energy"}),
    (["--word-timestamps"], {"word_passes": True}),
    (["--vocab-slice", "ja"], {}),
    (["--enhancer", "zipenhancer", "--enhancer-weights", "{zip}",
      "--enhancer-arg", "chunk_s=4"], {"enhanced_scenes": "scenes"}),
    (["--enhancer", "zip", "--enhancer-weights", "{zip}",
      "--enhance-for-vad"], {"enhanced_scenes": "scenes"}),
])
def test_cli_runs_the_new_modes_and_flags_on_the_cpu(tmp_path, flags, want):
    """Each mode and flag this slice ports, through the CLI on the CPU: an
    SRT and metadata come out, the enhancer ran on every scene, the
    chunked path replaced scenes, word alignment ran."""
    from whisperjav_tpu_torch.models.enhancement import zipenhancer as tzz
    from whisperjav_tpu_torch.models.whisper import word_align as twa
    zip_path = tmp_path / "zip.npz"
    tzz.save_params(str(zip_path), tzz.init_params(
        tzz.ZIP_TEST, torch.Generator().manual_seed(0)))
    flags = [f.replace("{zip}", str(zip_path)) for f in flags]
    wav = _short_wav(tmp_path)
    passes = twa.cross_attention_maps.launches
    assert cli.main([str(wav), "--output-dir", str(tmp_path / "out"),
                     *_CPU_RUN, *flags]) == 0
    assert (tmp_path / "out" / "short.ja.whisperjav.srt").exists()
    stats = json.loads((tmp_path / "out" / "short.whisperjav.json")
                       .read_text())["stats"]
    assert stats["windows"] >= 1
    for key, value in want.items():
        if key == "word_passes":
            assert (twa.cross_attention_maps.launches > passes) == value
        elif value == "scenes":
            assert stats[key] == stats["scenes"] >= 1, key
        else:
            assert stats[key] == value, key


@pytest.mark.parametrize("flags,want", [
    (["--mode", "fidelity"], {"model": "large-v2",
                              "enhancer_backend": "zipenhancer"}),
    (["--mode", "transformers", "--hf-chunk-length", "20", "--hf-stride",
      "4", "--hf-batch-size", "8", "--hf-beam-size", "3",
      "--hf-temperature", "0.1", "--hf-timestamps", "false"],
     {"model": "large-v2", "chunk_s": 20.0, "chunk_overlap_s": 4.0,
      "batch_size": 8}),
    (["--mode", "anime", "--word-timestamps", "--vocab-slice", "16384"],
     {"model": "large-v2", "word_timestamps": True,
      "vocab_slice": "16384"}),
    (["--enhancer", "dsp", "--enhancer-arg", "highpass_hz=100",
      "--enhance-for-vad"],
     {"enhancer_backend": "dsp", "enhancer_kwargs": {"highpass_hz": 100.0},
      "enhance_for_vad": True}),
])
def test_cli_resolves_the_new_flags_as_the_jax_cli(capsys, flags, want):
    """--dump-params: the resolved configuration of the new modes and
    flags, the --hf-* group included, equals the JAX CLI's resolution."""
    from whisperjav_tpu import cli as jcli
    assert cli.main(["clip.wav", *flags, "--dump-params"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    for key, value in want.items():
        assert dumped[key] == value, key
    assert jcli.main(["clip.wav", *flags, "--dump-params"]) == 0
    ref = json.loads(capsys.readouterr().out)
    for key in ("mode", "sensitivity", "model", "batch_size", "language"):
        assert dumped[key] == ref[key], key


def test_cli_flagless_defaults_are_the_slice(capsys):
    assert cli.main(["clip.wav", "--dump-params"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    assert dumped["mode"]["name"] == "balanced"
    assert dumped["mode"]["model"] == "turbo"
    assert dumped["mode"]["vad_backend"] == "silero"
    assert dumped["sensitivity"]["name"] == "balanced"
    assert dumped["sensitivity"]["beam_size"] == 2
    assert dumped["batch_size"] == 32
    assert dumped["int8_weights"] is False
    assert dumped["device"] == "cuda"


@pytest.mark.parametrize("flags,int8", [
    (["--int8-weights"], True),
    (["--compute-type", "int8"], True),
    (["--compute-type", "int8_float16"], True),
    (["--compute-type", "float16"], False),
    (["--int8-weights", "--compute-type", "float32"], False),
])
def test_cli_int8_weights_flags(capsys, flags, int8):
    """--int8-weights, and the faster-whisper spelling --compute-type
    int8* (float* turns it off), as the JAX CLI maps them."""
    assert cli.main(["clip.wav", "--model", "large-v2", *flags,
                     "--dump-params"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    assert dumped["int8_weights"] is int8
    assert dumped["model"] == "large-v2"


def test_cli_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where no GPU is visible")
    wav = _wav(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([str(wav), "--output-dir", str(tmp_path / "out")])
