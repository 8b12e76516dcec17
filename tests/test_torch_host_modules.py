"""The port's own copies of the JAX package's host modules give the same
results on the same inputs: scene detection and VAD, the sanitizer, the
preset resolution, the argument parser, the SRT reader and writer, the
enhancement framework (base, DSP enhancer), the vocabulary subset and
the monotonic aligner; and the two packages' loggers share one
handler."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from whisperjav_tpu import cli as jcli
from whisperjav_tpu.config import presets as jpresets
from whisperjav_tpu.modules import srt as jsrt
from whisperjav_tpu.modules.sanitize import SRTPostProcessor as JPost
from whisperjav_tpu.modules.scene_detection import (
    create_scene_detector as j_scene,
)
from whisperjav_tpu.modules.segmentation import create_segmenter as j_seg
from whisperjav_tpu_torch import cli_args as tcli
from whisperjav_tpu_torch.config import presets as tpresets
from whisperjav_tpu_torch.modules import srt as tsrt
from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor as TPost
from whisperjav_tpu_torch.modules.scene_detection import (
    create_scene_detector as t_scene,
)
from whisperjav_tpu_torch.modules.segmentation import (
    create_segmenter as t_seg,
)

SR = 16000


def _clip(seed: int) -> np.ndarray:
    """~70 s of speech-like bursts (3-9 s) between silences (1-3 s) and a
    quiet noise floor, from one seed."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0.0
    while total < 70.0:
        n = int(rng.uniform(3.0, 9.0) * SR)
        t = np.arange(n) / SR
        parts.append(0.3 * np.sin(2 * np.pi * rng.uniform(120, 260) * t)
                     * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
                     + 0.05 * rng.standard_normal(n))
        gap = int(rng.uniform(1.0, 3.0) * SR)
        parts.append(0.002 * rng.standard_normal(gap))
        total += (n + gap) / SR
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("kind,backend,kwargs", [
    ("scene", "energy", {}),
    ("scene", "none", {}),
    ("scene", "energy", {"max_scene_duration_s": 12.0}),
    ("vad", "silero", {}),
    ("vad", "silero", {"threshold": 0.41, "max_group_duration_s": 12.0}),
    ("vad", "energy", {}),
    ("vad", "none", {}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_scenes_and_groups_match(kind, backend, kwargs, seed):
    audio = _clip(seed)
    if kind == "scene":
        ref = j_scene(backend, **kwargs).detect(audio, SR)
        out = t_scene(backend, **kwargs).detect(audio, SR)
        assert len(ref.scenes) >= 1
        assert [dataclasses.asdict(s) for s in out.scenes] == \
            [dataclasses.asdict(s) for s in ref.scenes]
    else:
        ref = j_seg(backend, **kwargs).segment(audio, SR)
        out = t_seg(backend, **kwargs).segment(audio, SR)
        assert len(ref.groups) >= 1
        assert [dataclasses.asdict(g) for g in out.groups] == \
            [dataclasses.asdict(g) for g in ref.groups]
        assert [dataclasses.asdict(s) for s in out.segments] == \
            [dataclasses.asdict(s) for s in ref.segments]
    assert (out.backend, out.stats) == (ref.backend, ref.stats)


_SRT = """1
00:00:01,000 --> 00:00:02,500
こんにちは、今日はいい天気ですね。

2
00:00:02,600 --> 00:00:04,000
ご視聴ありがとうございました

3
00:00:04,100 --> 00:00:05,000
あああああああああああああああああああああああああ

4
00:00:05,200 --> 00:00:06,000
はい、はい、はい、はい、はい、はい、はい、はい

5
00:00:06,100 --> 00:00:06,900
そうですね

6
00:00:07,000 --> 00:00:07,800
そうですね

7
00:00:08,000 --> 00:00:09,000
チャンネル登録よろしくお願いします

8
00:00:09,100 --> 00:00:20,000
うん

9
00:00:20,100 --> 00:00:20,200
これはとても長い字幕で、短い時間の中に多すぎる文字が詰め込まれています。

10
00:00:21,000 --> 00:00:23,000
Thanks for watching!
"""


@pytest.mark.parametrize("language,preset", [
    ("ja", "default"), ("ja", "aggressive"), ("en", "default"),
])
def test_sanitizer_output_is_byte_equal(tmp_path, language, preset):
    ref_subs, ref_stats = JPost(regroup_preset=preset).process(
        jsrt.parse_srt(_SRT), language=language)
    out_subs, out_stats = TPost(regroup_preset=preset).process(
        tsrt.parse_srt(_SRT), language=language)
    assert len(ref_subs) < 10          # something was removed or merged
    jsrt.save_srt(tmp_path / "jax.srt", ref_subs)
    tsrt.save_srt(tmp_path / "torch.srt", out_subs)
    assert (tmp_path / "torch.srt").read_bytes() == \
        (tmp_path / "jax.srt").read_bytes()
    assert json.dumps(out_stats, sort_keys=True, default=str) == \
        json.dumps(ref_stats, sort_keys=True, default=str)


@pytest.mark.parametrize("mode", ["faster", "fast", "balanced"])
@pytest.mark.parametrize("sensitivity",
                         ["conservative", "balanced", "aggressive"])
@pytest.mark.parametrize("int8_weights", [False, True])
def test_resolved_pipeline_config_matches(mode, sensitivity, int8_weights):
    kw = dict(mode=mode, sensitivity=sensitivity, int8_weights=int8_weights)
    ref = jpresets.resolve_pipeline_config(**kw)
    out = tpresets.resolve_pipeline_config(**kw)
    assert json.dumps(dataclasses.asdict(out), sort_keys=True) == \
        json.dumps(dataclasses.asdict(ref), sort_keys=True)
    assert tpresets.config_fingerprint(out) == \
        jpresets.config_fingerprint(ref)


@pytest.mark.parametrize("argv", [
    ["clip.wav"],
    ["a.wav", "b.mp4", "--output-dir", "out", "--mode", "faster"],
    ["clip.wav", "--model", "large-v2", "--int8-weights"],
    ["clip.wav", "--compute-type", "int8_float16", "--sensitivity",
     "aggressive", "--batch-size", "16"],
    ["clip.wav", "--vad-backend", "silero", "--vad-arg", "threshold=0.3",
     "--scene-arg", "max_scene_duration_s=20", "--speech-pad-ms", "200"],
    ["clip.wav", "--no-sanitize", "--no-signature", "--output-format",
     "both", "--overrides", "sensitivity.beam_size=3"],
    ["clip.wav", "--word-timestamps", "--ensemble", "--devices", "4"],
    ["clip.wav", "--asr", "faster_whisper", "--features",
     "auditok_scene_detection", "--dump-params"],
])
def test_parser_gives_the_same_namespace(argv):
    assert vars(tcli.parse_arguments(argv)) == \
        vars(jcli.parse_arguments(argv))
    assert tcli._ASR_TO_MODE == jcli._ASR_TO_MODE
    assert tcli._FEATURE_TO_SCENE == jcli._FEATURE_TO_SCENE


@pytest.mark.parametrize("vtt", [False, True])
def test_srt_round_trip_matches(tmp_path, vtt):
    subs = [(0.0, 1.234, "一行目"), (1.5, 3.0, "二行目\n続き"),
            (3661.001, 3662.5, "over an hour")]
    for side, mod in (("jax", jsrt), ("torch", tsrt)):
        path = tmp_path / f"{side}.srt"
        mod.save_srt(path, [mod.Subtitle(i + 1, a, b, t)
                            for i, (a, b, t) in enumerate(subs)])
        if vtt:
            mod.srt_to_vtt(path)
    ext = "vtt" if vtt else "srt"
    assert (tmp_path / f"torch.{ext}").read_bytes() == \
        (tmp_path / f"jax.{ext}").read_bytes()
    ref = [dataclasses.asdict(s) for s in jsrt.load_srt(tmp_path / "jax.srt")]
    out = [dataclasses.asdict(s)
           for s in tsrt.load_srt(tmp_path / "torch.srt")]
    assert out == ref
    assert [(s["start"], s["end"], s["text"]) for s in out] == subs


@pytest.mark.parametrize("order", [
    ("whisperjav_tpu", "whisperjav_tpu_torch"),
    ("whisperjav_tpu_torch", "whisperjav_tpu"),
])
def test_both_packages_log_through_one_handler(order):
    """The port's logger keeps the JAX package's name: importing both, in
    either order, attaches one default handler to the one logger."""
    code = ("import importlib, logging\n"
            f"for pkg in {list(order)!r}:\n"
            "    importlib.import_module(pkg + '.utils.logger')\n"
            "print(len(logging.getLogger('whisperjav_tpu').handlers))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "1"


@pytest.mark.parametrize("n,chunk,fade", [(0, 100, 10), (95, 100, 10),
                                          (1000, 100, 10), (1234, 300, 0),
                                          (777, 50, 60)])
def test_chunked_crossfade_matches(n, chunk, fade):
    from whisperjav_tpu.modules.enhancement.base import (
        chunked_crossfade as j_fade,
    )
    from whisperjav_tpu_torch.modules.enhancement.base import (
        chunked_crossfade as t_fade,
    )
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)

    def apply(clip):            # a position-dependent map of each chunk
        return clip * np.linspace(0.5, 1.5, len(clip)) + 0.01

    np.testing.assert_array_equal(t_fade(audio, chunk, fade, apply),
                                  j_fade(audio, chunk, fade, apply))


@pytest.mark.parametrize("kwargs", [{}, {"deess": True},
                                    {"highpass_hz": None, "lowpass_hz": 4000,
                                     "compress_threshold_db": None},
                                    {"loudnorm_target_db": None}])
def test_dsp_enhancer_matches(kwargs):
    from whisperjav_tpu.modules.enhancement import create_enhancer as j_enh
    from whisperjav_tpu_torch.modules.enhancement import (
        create_enhancer as t_enh,
    )
    audio = _clip(2)[:5 * SR]
    ref = j_enh("dsp", **kwargs).enhance(audio, SR)
    out = t_enh("dsp", **kwargs).enhance(audio, SR)
    np.testing.assert_array_equal(out.audio, ref.audio)
    assert (out.success, out.backend, out.stats) == \
        (ref.success, ref.backend, ref.stats)


def test_enhancement_framework_matches():
    from whisperjav_tpu.modules import enhancement as jenh
    from whisperjav_tpu_torch.modules import enhancement as tenh
    for b in ("none", "NULL", "", None, "passthrough", "dsp", "zip"):
        assert tenh.is_passthrough_backend(b) == jenh.is_passthrough_backend(b)
    for b in ("none", "dsp", "zipenhancer", "bs-roformer", "clearvoice"):
        assert tenh.get_extraction_sample_rate(b) == \
            jenh.get_extraction_sample_rate(b)
    for b in ("bs-roformer", "vocals", "clearvoice", "mossformer"):
        got, want = tenh.create_enhancer(b), jenh.create_enhancer(b)
        assert (got.name, got.is_lightweight,
                got.get_preferred_sample_rate()) == \
            (want.name, want.is_lightweight,
             want.get_preferred_sample_rate())
    assert (tenh.get_extraction_sample_rate("bs-roformer"),
            tenh.get_extraction_sample_rate("clearvoice")) == (44_100,
                                                               48_000)

    class Failing:
        name = "failing"

        def enhance(self, audio, sample_rate):
            raise RuntimeError("device lost")

    audio = _clip(3)[:SR]
    for mod in (jenh, tenh):
        (res,) = mod.enhance_scenes(Failing(), [audio], SR)
        assert res.audio is audio and not res.success
        assert res.stats == {"error": "device lost"}


def test_vocab_subset_matches():
    from whisperjav_tpu.models.whisper import vocab_subset as jvs
    from whisperjav_tpu.models.whisper.config import WHISPER_SIZES as JS
    from whisperjav_tpu.models.whisper.decode import DecodeOptions as JOpts
    from whisperjav_tpu_torch.models.whisper import vocab_subset as tvs
    from whisperjav_tpu_torch.models.whisper.config import (
        WHISPER_SIZES as TS,
    )
    from whisperjav_tpu_torch.models.whisper.decode import (
        DecodeOptions as TOpts,
    )
    for name in ("large-v2", "turbo"):
        keep = np.asarray([3, 10, 220, 999, 5000], np.int32)
        ref, out = jvs.VocabSubset(JS[name], keep), tvs.VocabSubset(TS[name],
                                                                  keep)
        np.testing.assert_array_equal(out.sub_ids, ref.sub_ids)
        assert dataclasses.asdict(out.config) == dataclasses.asdict(ref.config)
        for prop in ("eot", "sot", "translate", "transcribe", "sot_prev",
                     "no_speech", "no_timestamps", "timestamp_begin",
                     "vocab_shift"):
            assert getattr(out.config, prop) == getattr(ref.config, prop)
        ids = [10, 11, 220, JS[name].timestamp_begin + 3, JS[name].eot]
        assert out.to_subset(ids) == ref.to_subset(ids)
        np.testing.assert_array_equal(out.to_full([0, 4, 6]),
                                      ref.to_full([0, 4, 6]))
        r_opts = ref.remap_options(JOpts(suppress_tokens=(10, 11, 999)))
        o_opts = out.remap_options(TOpts(suppress_tokens=(10, 11, 999)))
        assert (o_opts.suppress_tokens, o_opts.blank_token) == \
            (r_opts.suppress_tokens, r_opts.blank_token)
        np.testing.assert_array_equal(
            tvs.synthetic_text_ids(TS[name], 777),
            jvs.synthetic_text_ids(JS[name], 777))

    class Tok:                  # a "real" tokenizer over a few ids
        is_real = True

        def decode(self, ids):
            return {0: "a", 1: "\u3042", 2: "\u0416", 3: "\ufffd",
                    4: "\u30ab\u30ca"}.get(ids[0], "x")

    cfg_j = dataclasses.replace(JS["large-v2"])
    cfg_t = dataclasses.replace(TS["large-v2"])
    np.testing.assert_array_equal(tvs.ja_text_ids(Tok(), cfg_t),
                                  jvs.ja_text_ids(Tok(), cfg_j))
    assert tvs.ja_text_ids(object(), cfg_t) is None
    adapter = tvs.SubsetTokenizerAdapter(
        tvs.VocabSubset(cfg_t, [2, 4]), Tok())
    assert adapter.decode([1]) == "\u30ab\u30ca" and adapter.is_real


@pytest.mark.parametrize("module,names", [
    ("translate.providers", ("PROVIDERS",)),
    ("translate.instructions", ("_BUNDLED", "INSTRUCTION_URLS")),
    ("translate.settings", ("DEFAULT_SETTINGS", "SETTINGS_VERSION")),
    ("translate.project", ("SCHEMA_VERSION", "DEFAULT_SCENE_THRESHOLD")),
    ("translate.ollama_manager", ("MODEL_LADDER", "DEFAULT_BASE_URL")),
    ("ensemble.merge", ("MERGE_STRATEGIES",)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_copied_tables_match(module, names):
    """The tables the ensemble and translate copies hold (providers and
    their limits, bundled instructions, settings defaults, the project
    schema, the Ollama VRAM ladder, the merge strategies' names) equal
    the JAX package's."""
    import importlib
    ref = importlib.import_module(f"whisperjav_tpu.{module}")
    out = importlib.import_module(f"whisperjav_tpu_torch.{module}")
    for name in names:
        a, b = getattr(out, name), getattr(ref, name)
        if name == "MERGE_STRATEGIES":
            a, b = sorted(a), sorted(b)
        assert json.dumps(a, sort_keys=True, default=repr) == \
            json.dumps(b, sort_keys=True, default=repr), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_translation_batching_matches(seed):
    """Scenes, gap-aligned batches, the context block, numbered-response
    parsing, summaries and the output-language tag of the translate copy
    give the JAX package's results."""
    from whisperjav_tpu.translate import project as jp
    from whisperjav_tpu.translate import service as js
    from whisperjav_tpu_torch.translate import project as tp
    from whisperjav_tpu_torch.translate import service as ts
    rng = np.random.default_rng(seed)
    cues, t = [], 0.0
    for i in range(60):
        t += float(rng.choice([0.3, 1.0, 5.0, 80.0], p=[.5, .3, .15, .05]))
        cues.append((i + 1, t, t + 1.5, f"line {i}"))
        t += 1.5
    out = [jp.split_batches(sc, 7) for sc in jp.split_scenes(
        [jsrt.Subtitle(*c) for c in cues], 60.0)]
    got = [tp.split_batches(sc, 7) for sc in tp.split_scenes(
        [tsrt.Subtitle(*c) for c in cues], 60.0)]
    assert [[[s.index for s in b] for b in sc] for sc in got] == \
        [[[s.index for s in b] for b in sc] for sc in out]
    text = "1: a\n2：b\n 3) c\nx\n4. d\n<summary> s </summary>"
    assert ts.parse_numbered_response(text) == \
        js.parse_numbered_response(text)
    assert tp.extract_summary(text) == jp.extract_summary(text) == "s"
    for lang in ("English", "pt", "Klingon", ""):
        assert ts._iso_tag(lang) == js._iso_tag(lang)


def test_tracer_records_match(tmp_path):
    """The tracer copy writes the JAX tracer's records (numpy values made
    JSON-safe), ``t``/``ts`` aside; the null tracer writes nothing."""
    from whisperjav_tpu.utils import tracer as jt
    from whisperjav_tpu_torch.utils import tracer as tt
    data = {"a": np.int64(3), "b": np.float32(0.5), "c": np.arange(3),
            "d": (1, {"e": np.float64(2.0)})}
    for mod, name in ((jt, "j.jsonl"), (tt, "t.jsonl")):
        with mod.create_tracer(tmp_path / name) as tr:
            tr.event("segmentation", data)
            tr.event("file_complete")
        mod.create_tracer(None).event("x", data)
    recs = {n: [json.loads(x) for x in (tmp_path / n).read_text()
                .splitlines()] for n in ("j.jsonl", "t.jsonl")}
    strip = lambda rs: [(r["event"], r["data"]) for r in rs]  # noqa: E731
    assert strip(recs["t.jsonl"]) == strip(recs["j.jsonl"])
    assert recs["t.jsonl"][0]["data"]["c"] == [0, 1, 2]
