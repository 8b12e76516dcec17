"""The port's decoupled-subtitle host modules vs the JAX package's copies,
on the CPU, with seeded numpy inputs: semantic scenes (scipy clustering
against the JAX detector's scikit-learn clustering), the whisperseg
energy path, sentinel, hardening, reconstruction, framers, cleaners,
the aligner adapter's buckets and analytics. Host code on both sides:
results equal exactly (floats compared with ==)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.models.qwen.aligner import ForcedAligner as JaxAligner
from whisperjav_tpu.modules import analytics as jan
from whisperjav_tpu.modules.scene_detection import semantic as jsem
from whisperjav_tpu.modules.segmentation import whisperseg as jws
from whisperjav_tpu.modules.srt import Subtitle as JSub
from whisperjav_tpu.modules.subtitle_pipeline import components as jc
from whisperjav_tpu.modules.subtitle_pipeline import hardening as jh
from whisperjav_tpu.modules.subtitle_pipeline import reconstruction as jr
from whisperjav_tpu.modules.subtitle_pipeline import sentinel as jse
from whisperjav_tpu.modules.subtitle_pipeline import types as jt
from whisperjav_tpu.pipelines.qwen import safe_chunk_scenes as j_safe
from whisperjav_tpu.modules.scene_detection.base import Scene as JScene
from whisperjav_tpu_torch.models.qwen import aligner as ta
from whisperjav_tpu_torch.modules import analytics as tan
from whisperjav_tpu_torch.modules.scene_detection import create_scene_detector
from whisperjav_tpu_torch.modules.scene_detection import semantic as tsem
from whisperjav_tpu_torch.modules.scene_detection.base import Scene as TScene
from whisperjav_tpu_torch.modules.segmentation import create_segmenter
from whisperjav_tpu_torch.modules.segmentation import whisperseg as tws
from whisperjav_tpu_torch.modules.srt import Subtitle as TSub
from whisperjav_tpu_torch.modules.subtitle_pipeline import components as tc
from whisperjav_tpu_torch.modules.subtitle_pipeline import hardening as th
from whisperjav_tpu_torch.modules.subtitle_pipeline import protocols as tp
from whisperjav_tpu_torch.modules.subtitle_pipeline import reconstruction as tr
from whisperjav_tpu_torch.modules.subtitle_pipeline import sentinel as tse
from whisperjav_tpu_torch.modules.subtitle_pipeline import types as tt
from whisperjav_tpu_torch.pipelines.qwen import safe_chunk_scenes as t_safe

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread keeps the suite's workers from
    oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tone(seconds, freq, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * freq * t)
            + noise * rng.standard_normal(t.size)).astype(np.float32)


def speech_like(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * (170 + 20 * seed) * t) \
        * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def bursts(seconds, seed):
    """Speech-like bursts (2-8 s) between silences (0.5-3 s)."""
    rng = np.random.default_rng(seed)
    parts, total, k = [], 0.0, 0
    while total < seconds:
        sp, gap = float(rng.uniform(2, 8)), float(rng.uniform(0.5, 3))
        parts += [speech_like(sp, seed + k), np.zeros(int(gap * SR),
                                                      np.float32)]
        total += sp + gap
        k += 1
    return np.concatenate(parts)


def _scenes(result):
    return [(s.index, s.start, s.end, s.scene_type) for s in result.scenes]


# ---------------------------------------------------------------------------
# semantic scenes
# ---------------------------------------------------------------------------

def _clips():
    rng = np.random.default_rng(1)
    return {
        "two-textures": np.concatenate(
            [tone(30, 200), (0.2 * rng.standard_normal(30 * SR)
                             ).astype(np.float32)]),
        "bursts-75s": bursts(75, 3),
        "short": tone(5, 300),
        "four-textures": np.concatenate(
            [tone(25, 200), bursts(30, 7), tone(25, 900, 2, 0.1),
             (0.05 * rng.standard_normal(25 * SR)).astype(np.float32)]),
        # over max_scene_s (420 s): the split of an over-long scene
        "stationary-450s": tone(450, 250, 4),
    }


@pytest.mark.parametrize("name", list(_clips()))
@pytest.mark.parametrize("kwargs", [{}, {"min_scene_s": 10.0}],
                         ids=["default", "min10"])
def test_semantic_boundaries_match_jax(name, kwargs):
    audio = _clips()[name]
    want = jsem.SemanticSceneDetector(**kwargs).detect(audio, SR)
    got = create_scene_detector("semantic", **kwargs).detect(audio, SR)
    assert got.backend == "semantic"
    assert _scenes(got) == _scenes(want)
    assert got.stats == want.stats
    if name == "stationary-450s":
        assert len(got.scenes) >= 2
        assert all(s.duration <= 420.0 for s in got.scenes)


@pytest.mark.parametrize("seed", range(12))
def test_cluster_boundaries_match_sklearn(seed):
    """The scipy tree cut against scikit-learn's agglomerative clustering
    (cosine, average linkage, distance threshold) on random textures,
    some with repeated rows (ties) and at several thresholds."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 120))
    k = int(rng.integers(1, 5))
    centers = rng.standard_normal((k, 26)) * 2
    feats = centers[rng.integers(0, k, n)] + rng.standard_normal((n, 26))
    if seed % 3 == 0:
        feats[n // 2:n // 2 + 3] = feats[n // 2]
    for thr in (0.3, 0.7, 1.0):
        j = jsem.SemanticSceneDetector(distance_threshold=thr)
        t = tsem.SemanticSceneDetector(distance_threshold=thr)
        assert t._cluster_boundaries(feats.astype(np.float32)) \
            == j._cluster_boundaries(feats.astype(np.float32))


def test_mfcc_and_textures_match_jax():
    audio = bursts(12, 5)
    m = tsem.compute_mfcc(audio, SR)
    np.testing.assert_array_equal(m, jsem.compute_mfcc(audio, SR))
    np.testing.assert_array_equal(tsem.texture_features(m, 100),
                                  jsem.texture_features(m, 100))


def test_safe_chunk_scenes_matches_jax():
    spans = [(0.0, 100.0), (100.0, 105.0), (105.0, 140.0), (140.0, 141.0),
             (141.0, 300.0), (300.0, 311.0)]
    for mx, mn in ((48.0, 12.0), (30.0, 5.0)):
        got = t_safe([TScene(i, a, b) for i, (a, b) in enumerate(spans)],
                     max_s=mx, min_s=mn)
        want = j_safe([JScene(i, a, b) for i, (a, b) in enumerate(spans)],
                      max_s=mx, min_s=mn)
        assert [(s.index, s.start, s.end) for s in got] \
            == [(s.index, s.start, s.end) for s in want]


# ---------------------------------------------------------------------------
# whisperseg (energy probability)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"max_group_duration_s": 3.0},
                                    {"threshold": 0.35, "pad_end_s": 0.2}])
def test_whisperseg_energy_path_matches_jax(kwargs):
    audio = bursts(40, 11)
    want = jws.WhisperSegSegmenter(**kwargs).segment(audio, SR)
    got = create_segmenter("whisperseg", **kwargs).segment(audio, SR)
    assert got.backend == "whisperseg"
    assert [(s.start, s.end, s.prob) for s in got.segments] \
        == [(s.start, s.end, s.prob) for s in want.segments]
    assert [(g.start, g.end, len(g.segments)) for g in got.groups] \
        == [(g.start, g.end, len(g.segments)) for g in want.groups]
    assert got.stats == want.stats
    np.testing.assert_array_equal(
        tws.WhisperSegSegmenter().frame_probs(audio, SR),
        jws.WhisperSegSegmenter().frame_probs(audio, SR))


def test_whisperseg_weights_not_ported(tmp_path):
    """The WhisperSeg network is ported: weights load (on the CPU here),
    a missing file raises rather than falling back to the energy
    probability, and a CUDA device without a GPU raises."""
    from whisperjav_tpu_torch.models.vad import whisperseg as ws
    from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
    cfg = WhisperConfig(name="seg-narrow", n_mels=80, n_audio_state=64,
                        n_audio_head=8, n_audio_layer=1, n_vocab=64,
                        n_text_ctx=1500, n_text_state=64, n_text_head=8,
                        n_text_layer=2)
    npz = tmp_path / "model.npz"
    ws.save_params(str(npz), ws.init_params(torch.Generator().manual_seed(0),
                                            cfg))
    seg = create_segmenter("whisperseg", weights=str(npz), device="cpu")
    res = seg.segment(bursts(8, 3), SR)
    assert res.stats["model"] == "network"
    with pytest.raises(FileNotFoundError):
        create_segmenter("whisperseg", weights=str(tmp_path / "no.npz"),
                         device="cpu")


# ---------------------------------------------------------------------------
# sentinel, hardening, reconstruction
# ---------------------------------------------------------------------------

def _word_cases():
    rng = np.random.default_rng(2)
    cases = []
    for k in range(20):
        n = int(rng.integers(0, 14))
        words, t = [], float(rng.uniform(0, 2))
        for i in range(n):
            text = "".join(rng.choice(list("あいうえおかき。、！？ab"),
                                      int(rng.integers(1, 4))))
            d = float(rng.uniform(0.0, 1.5))
            null = rng.uniform() < (0.5 if k % 4 == 0 else 0.15)
            pile = k % 5 == 1
            start = 0.01 * i if pile else t
            words.append((text, None if null else start,
                          None if null else start + (0.001 if pile else d)))
            t += d + float(rng.uniform(0, 2.5 if k % 3 else 0.2))
        cases.append(words)
    return cases


def _words(mod, case):
    return [mod.WordTimestamp(w, s, e) for w, s, e in case]


def _tuples(words):
    return [(w.word, w.start, w.end, w.prob) for w in words]


@pytest.mark.parametrize("i", range(20))
def test_sentinel_matches_jax(i):
    case = _word_cases()[i]
    q_t = tse.assess_alignment_quality(_words(tt, case), 8.0)
    q_j = jse.assess_alignment_quality(_words(jt, case), 8.0)
    assert dataclasses.astuple(q_t) == dataclasses.astuple(q_j)
    for regions in (None, [(0.5, 2.0), (3.0, 6.5)], [(1.0, 1.0)]):
        assert _tuples(tse.redistribute_collapsed_words(
            _words(tt, case), 8.0, regions)) \
            == _tuples(jse.redistribute_collapsed_words(
                _words(jt, case), 8.0, regions))


@pytest.mark.parametrize("mode", [m.value for m in jt.TimestampMode])
def test_hardening_matches_jax(mode):
    for case in _word_cases():
        got = th.harden_words(_words(tt, case), 12.0,
                              tt.HardeningConfig(tt.TimestampMode(mode)),
                              [(0.5, 4.0), (6.0, 11.0)])
        want = jh.harden_words(_words(jt, case), 12.0,
                               jt.HardeningConfig(jt.TimestampMode(mode)),
                               [(0.5, 4.0), (6.0, 11.0)])
        assert _tuples(got[0]) == _tuples(want[0]) and got[1] == want[1]


@pytest.mark.parametrize("mode", [m.value for m in jt.RegroupMode])
def test_reconstruction_matches_jax(mode):
    for case in _word_cases():
        hard = jh.harden_words(_words(jt, case), 30.0, jt.HardeningConfig())[0]
        case = [(w.word, w.start, w.end) for w in hard]
        for kw in ({}, {"max_cue_chars": 6, "max_cue_duration_s": 3.0}):
            got = tr.regroup_words(_words(tt, case), tt.RegroupMode(mode),
                                   tr.RegroupConfig(**kw))
            want = jr.regroup_words(_words(jt, case), jt.RegroupMode(mode),
                                    jr.RegroupConfig(**kw))
            assert [(c.index, c.start, c.end, c.text) for c in got] \
                == [(c.index, c.start, c.end, c.text) for c in want]


def test_types_mirror_jax():
    for name in ("TemporalFrame", "FramingResult", "TranscriptionResult",
                 "WordTimestamp", "AlignmentResult", "StepDownConfig",
                 "HardeningConfig", "SceneDiagnostics"):
        assert ([f.name for f in dataclasses.fields(getattr(tt, name))]
                == [f.name for f in dataclasses.fields(getattr(jt, name))])
    d = tt.SceneDiagnostics(scene_index=2, frames=3).to_dict()
    assert d == jt.SceneDiagnostics(scene_index=2, frames=3).to_dict()
    assert isinstance(tc.VadGroupedFramer(), tp.TemporalFramer)
    assert isinstance(tc.QwenGenerator(device="cpu"), tp.TextGenerator)
    assert isinstance(tc.PassthroughCleaner(), tp.TextCleaner)
    assert isinstance(tc.NullAligner(), tp.TextAligner)


# ---------------------------------------------------------------------------
# framers, cleaners, aligners
# ---------------------------------------------------------------------------

def _frames(result):
    return ([(f.index, f.start, f.end, f.speech_regions)
             for f in result.frames], result.backend,
            result.scene_duration, result.speech_regions)


@pytest.mark.parametrize("backend", ["whisperseg", "silero", "energy"])
def test_vad_grouped_framer_matches_jax(backend):
    audio = bursts(30, 13)
    for max_group in (6.0, 3.0):
        got = tc.create_framer("vad-grouped", vad_backend=backend
                               ).frame(audio, SR, max_group)
        want = jc.create_framer("vad-grouped", vad_backend=backend
                                ).frame(audio, SR, max_group)
        assert _frames(got) == _frames(want)


def test_other_framers_match_jax(tmp_path):
    audio = bursts(20, 17)
    assert _frames(tc.create_framer("full-scene").frame(audio, SR, 6.0)) \
        == _frames(jc.create_framer("full-scene").frame(audio, SR, 6.0))
    b = [(0.5, 3.0), (-1.0, 2.0), (18.0, 99.0)]
    assert _frames(tc.create_framer("manual", boundaries=b).frame(
        audio, SR, 6.0)) == _frames(jc.create_framer(
            "manual", boundaries=b).frame(audio, SR, 6.0))
    srt = tmp_path / "in.srt"
    srt.write_text("1\n00:00:01,000 --> 00:00:03,500\nあ\n\n"
                   "2\n00:00:19,000 --> 00:00:25,000\nい\n\n",
                   encoding="utf-8")
    assert _frames(tc.create_framer("srt-source", srt_path=str(srt)).frame(
        audio, SR, 6.0)) == _frames(jc.create_framer(
            "srt-source", srt_path=str(srt)).frame(audio, SR, 6.0))


def test_cleaners_match_jax():
    texts = ["こんにちはこんにちはこんにちはこんにちはこんにちは",
             "ご視聴ありがとうございました", "", "はい、そうです。"]
    res_t = [tt.TranscriptionResult(i, x, -0.5) for i, x in enumerate(texts)]
    res_j = [jt.TranscriptionResult(i, x, -0.5) for i, x in enumerate(texts)]
    for name in ("assembly", "passthrough"):
        got = tc.create_cleaner(name).clean_batch(res_t)
        want = jc.create_cleaner(name).clean_batch(res_j)
        assert [dataclasses.astuple(r) for r in got] \
            == [dataclasses.astuple(r) for r in want]


def test_null_aligner_matches_jax():
    texts = ["あい う", "", "x y z"]
    clips = [np.zeros(SR, np.float32)] * 3
    got = tc.create_aligner("none").align_batch(clips, SR, texts)
    want = jc.create_aligner("none").align_batch(clips, SR, texts)
    assert [(r.frame_index, _tuples(r.words)) for r in got] \
        == [(r.frame_index, _tuples(r.words)) for r in want]


def test_aligner_adapter_matches_jax():
    """Buckets (audio 2/4/8 s, tokens 16/64), an empty text and a clip
    shorter than its tokens: word spans identical, on the JAX aligner's
    weights."""
    jal = JaxAligner()
    params = ta.params_from_jax(jax.tree.map(np.asarray, jal.params),
                                ta.AlignerConfig())
    tad = tc.QwenAlignerAdapter(
        aligner=ta.ForcedAligner(params=params, device="cpu"), device="cpu")
    jad = jc.QwenAlignerAdapter(aligner=jal)
    clips = [speech_like(1.5, 1), speech_like(3.2, 2), speech_like(7.0, 3),
             speech_like(0.2, 4), speech_like(2.5, 5)]
    texts = ["こんにちは世界", "ありがとうございます。" * 3, "はい",
             "あいうえおかきくけこさしすせそ", "  "]
    got = tad.align_batch(clips, SR, texts)
    want = jad.align_batch(clips, SR, texts)
    assert [(r.frame_index, _tuples(r.words)) for r in got] \
        == [(r.frame_index, _tuples(r.words)) for r in want]
    assert sorted(tad.buckets(clips, SR, texts)) == [(2, 16), (4, 64),
                                                    (8, 16)]


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------

def test_analytics_match_jax():
    spans = [(0.0, 1.0), (1.2, 1.3), (1.25, 4.0), (40.0, 41.0),
             (41.5, 41.6)]
    texts = ["あいう", "え", "おかきくけこさしすせそたちつてとなにぬねのはひふへほ",
             "ま", "み"]
    diags = [tt.SceneDiagnostics(0, frames=3, aligned_words=10,
                                 null_timestamp_words=2, collapsed_frames=1,
                                 step_down_retries=1).to_dict(),
             tt.SceneDiagnostics(1, frames=2, aligned_words=4).to_dict()]
    for n in (0, 1, 5):
        got = tan.compute_full_analytics(
            [TSub(i + 1, a, b, x) for i, ((a, b), x)
             in enumerate(zip(spans[:n], texts))], 90.0,
            scene_spans=[(0.0, 45.0), (45.0, 90.0)],
            scene_diagnostics=diags, speech_regions_s=30.0)
        want = jan.compute_full_analytics(
            [JSub(i + 1, a, b, x) for i, ((a, b), x)
             in enumerate(zip(spans[:n], texts))], 90.0,
            scene_spans=[(0.0, 45.0), (45.0, 90.0)],
            scene_diagnostics=diags, speech_regions_s=30.0)
        assert got == want
    tan.print_summary(got, title="clip")
