"""Fidelity and transformers mode through the port's file pipeline against
the JAX pipeline on the same weights (a tiny Whisper, f32 on the CPU):
the fidelity path denoises every scene with the ZipEnhancer (ZIP_TEST
weights from one .npz, read by both packages), with and without the dual
track of --enhance-for-vad; the transformers path decodes overlapped
chunks and keeps each chunk's own span.

Under reflect padding the first STFT frame of an enhancer chunk is
symmetric about its centre, so its imaginary parts are rounding noise
and the phase the network takes there depends on the order of the
convolution's sums (tests/test_torch_zipenhancer.py): where a chunk
starts inside speech, as every energy scene does, the two packages'
denoised audio parts by up to ~0.2 and nearly every int16 sample the
engine uploads differs. At the fidelity presets the test therefore
holds the port to the JAX pipeline's windows, metadata and SRT (before
and after the sanitizer); with one scene whose chunks all start in
silence it holds every window's decode too.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.enhancement import zipenhancer as jzz
from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.media_discovery import probe
from whisperjav_tpu.modules.sanitize import SRTPostProcessor
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu.pipelines.transcribe import TranscribePipeline as JPipe
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.modules.media_discovery import probe as t_probe
from whisperjav_tpu_torch.modules.sanitize import (
    SRTPostProcessor as TorchSRTPostProcessor,
)
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines.transcribe import (
    TranscribePipeline as TPipe,
)

_DIMS = dict(name="torch-modes-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
SR = 16000
# the balanced sensitivity's decoding and gates, one rung
COMMON = dict(repetition_penalty=1.5, no_repeat_ngram_size=3, beam_size=2,
              patience=1.2, best_of=2, cross_kv_int8=True)
GATES = dict(logprob_threshold=-0.92, no_speech_threshold=0.65,
             temperatures=(0.0,))
VAD = dict(threshold=0.28, max_group_duration_s=6.0)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def speech_like(duration_s, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three clips: six 8 s bursts and three 20 s bursts between 3 s
    silences; 28.5 s with three 7.5 s bursts placed so that every 10 s
    enhancer chunk (hop 9.5 s) starts in silence. The ZIP_TEST weights
    file and the Whisper weights."""
    tmp = tmp_path_factory.mktemp("modes")
    wavs = {}
    for name, bursts in (("short", [(3 + 11 * i, 8) for i in range(6)]),
                         ("long", [(3 + 23 * i, 20) for i in range(3)]),
                         ("aligned", [(1 + 9.5 * i, 7.5)
                                      for i in range(3)])):
        end = max(a + d for a, d in bursts) + (1 if name == "aligned" else 3)
        audio = np.zeros(int(end * SR), np.float32)
        for i, (a, d) in enumerate(bursts):
            x = speech_like(d, i)
            audio[int(a * SR):int(a * SR) + len(x)] = x
        wavs[name] = tmp / name / "clip.wav"
        wavs[name].parent.mkdir()
        write_wav(wavs[name], audio, SR)
    zip_path = str(tmp / "zip.npz")
    jzz.save_params(zip_path, jzz.init_params(jax.random.PRNGKey(5),
                                              jzz.ZIP_TEST), jzz.ZIP_TEST)
    return wavs, zip_path, init_params(CFG, jax.random.PRNGKey(7))


def _run_both(tmp_path, inputs, clip="short", **kw):
    wavs, _, params = inputs
    wav = wavs[clip]
    jeng = je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(**COMMON),
        thresholds=je.QualityThresholds(**GATES), batch_size=4,
        compute_dtype=jnp.float32)
    ref = JPipe(jeng, vad_backend="silero", vad_kwargs=VAD,
                postprocessor=SRTPostProcessor(), keep_intermediates=True,
                **kw).process(probe(wav), tmp_path / "jax")
    teng = te.TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(**COMMON),
        thresholds=te.QualityThresholds(**GATES), batch_size=4,
        device="cpu", compute_dtype=torch.float32)
    out = TPipe(teng, vad_backend="silero", vad_kwargs=VAD,
                postprocessor=TorchSRTPostProcessor(),
                keep_intermediates=True, **kw).process(t_probe(wav),
                                                       tmp_path / "torch")
    return ref, out


def _same_outputs(tmp_path, ref, out, keys, decodes=True):
    """The metadata under ``keys``, the SRT before and after the sanitizer,
    every window's placement and, with ``decodes``, its decode."""
    for key in keys:
        assert out.metadata["stats"][key] == ref.metadata["stats"][key], key
    for name in ("clip.ja.whisperjav.raw.srt", "clip.ja.whisperjav.srt"):
        assert (tmp_path / "torch" / name).read_text(encoding="utf-8") == \
            (tmp_path / "jax" / name).read_text(encoding="utf-8"), name
    diag = {side: json.loads((tmp_path / side / "clip.transcribe.json")
                             .read_text())["windows"]
            for side in ("jax", "torch")}
    place = ("scene", "group", "start", "duration")
    assert [[w[k] for k in place] for w in diag["torch"]] == \
        [[w[k] for k in place] for w in diag["jax"]]
    if decodes:
        assert diag["torch"] == diag["jax"]
    return diag["torch"]


@pytest.mark.parametrize("enhance_for_vad", [False, True])
def test_fidelity_pipeline_matches_jax(tmp_path, inputs, enhance_for_vad):
    """The fidelity presets (energy scenes, silero VAD) on six scenes."""
    _, zip_path, _ = inputs
    ref, out = _run_both(tmp_path, inputs, enhancer_backend="zipenhancer",
                         enhancer_kwargs={"weights": zip_path},
                         enhance_for_vad=enhance_for_vad)
    stats = out.metadata["stats"]
    assert stats["scenes"] == 6
    assert stats["enhanced_scenes"] == stats["scenes"]
    assert stats["stage_s"]["enhance"] > 0.0
    assert stats["raw_subtitles"] >= 2
    _same_outputs(tmp_path, ref, out,
                  ("windows", "scenes", "groups", "enhanced_scenes",
                   "failovers", "groups_packed", "raw_subtitles",
                   "final_subtitles"), decodes=enhance_for_vad)


def test_fidelity_decodes_match_where_chunks_start_in_silence(tmp_path,
                                                              inputs):
    """One scene over the whole clip (scene backend "none"), every
    enhancer chunk starting in silence, one window per VAD group: every
    window decodes the JAX pipeline's tokens, and they are not the tokens
    of the original audio."""
    _, zip_path, _ = inputs
    kw = dict(clip="aligned", scene_backend="none", pack=False)
    ref, out = _run_both(tmp_path / "enh", inputs,
                         enhancer_backend="zipenhancer",
                         enhancer_kwargs={"weights": zip_path}, **kw)
    stats = out.metadata["stats"]
    assert stats["enhanced_scenes"] == stats["scenes"] == 1
    diag = _same_outputs(tmp_path / "enh", ref, out,
                         ("windows", "scenes", "groups", "enhanced_scenes",
                          "raw_subtitles", "final_subtitles"))
    assert len(diag) >= 3
    _, plain = _run_both(tmp_path / "plain", inputs, **kw)
    assert plain.metadata["stats"]["enhanced_scenes"] == 0
    assert json.loads((tmp_path / "plain" / "torch" / "clip.transcribe.json")
                      .read_text())["windows"] != diag


def test_transformers_pipeline_matches_jax(tmp_path, inputs):
    """30 s chunks overlapping by 5 s over 69 s: three windows, each
    keeping the segments whose midpoint lies in its own span."""
    ref, out = _run_both(tmp_path, inputs, clip="long", chunked=True)
    stats = out.metadata["stats"]
    assert stats["scene_backend"] == "chunked"
    assert stats["windows"] == 3
    diag = _same_outputs(tmp_path, ref, out,
                         ("windows", "scenes", "groups", "raw_subtitles",
                          "final_subtitles"))
    assert [w["start"] for w in diag] == [0.0, 25.0, 50.0]
