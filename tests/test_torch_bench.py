"""The port's ``bench/`` against the JAX package's: every metric, the
matcher, the loader, provenance, the full report, the forensic CSV and
the ``whisperjav-torch-bench`` command line give equal results on the
same SRTs (host numpy on both sides: exact, not within a tolerance).

Inputs: the SRT fixtures of ``tests/test_bench_{metrics,report,cli}.py``
and ``tests/test_forensic.py``, and seeded random cue sets."""

import dataclasses
import json

import numpy as np
import pytest

from whisperjav_tpu.bench import cli as jcli
from whisperjav_tpu.bench import forensic as jfor
from whisperjav_tpu.bench import loader as jload
from whisperjav_tpu.bench import matcher as jmatch
from whisperjav_tpu.bench import metrics as jmet
from whisperjav_tpu.bench import provenance as jprov
from whisperjav_tpu.bench import report as jrep
from whisperjav_tpu.modules.srt import Subtitle as JSub
from whisperjav_tpu.modules.srt import save_srt
from whisperjav_tpu_torch.bench import cli as tcli
from whisperjav_tpu_torch.bench import forensic as tfor
from whisperjav_tpu_torch.bench import loader as tload
from whisperjav_tpu_torch.bench import matcher as tmatch
from whisperjav_tpu_torch.bench import metrics as tmet
from whisperjav_tpu_torch.bench import provenance as tprov
from whisperjav_tpu_torch.bench import report as trep
from whisperjav_tpu_torch.modules.srt import Subtitle as TSub

GT = [(1, 1.0, 3.0, "こんにちは世界"),
      (2, 5.0, 7.0, "ありがとうございます"),
      (3, 10.0, 12.0, "さようなら")]
TEST = [(1, 1.1, 2.9, "こんにちは世界"), (2, 5.2, 6.8, "ありがとう"),
        (3, 8.0, 8.5, "幻覚です")]
WINDOWS = [{"scene": 0, "group": 0, "start": 0.0, "duration": 8.0,
            "avg_logprob": -0.5, "no_speech_prob": 0.1},
           {"scene": 1, "group": 0, "start": 8.0, "duration": 8.0,
            "avg_logprob": -2.5, "no_speech_prob": 0.2}]
KANA = list("あいうえおかきくけこさしすせそ（）[]：abc ")


def _subs(cls, cues):
    return [cls(i, a, b, t) for i, a, b, t in cues]


def _random_cues(seed, n=14):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.uniform(0.0, 2.0))
        d = float(rng.uniform(0.1, 4.0))
        text = "".join(rng.choice(KANA, int(rng.integers(0, 16))))
        if rng.uniform() < 0.2:
            text = "（田中）" + text
        out.append((i + 1, round(t, 3), round(t + d, 3), text))
        t += d * float(rng.uniform(0.0, 1.1))
    return out


def _plain(x):
    """Dataclass/namedtuple-free JSON form (NaN kept as a string)."""
    return json.loads(json.dumps(x, default=str, allow_nan=True))


CASES = [("fixtures", GT, TEST)] + [
    (f"seed{s}", _random_cues(s), _random_cues(100 + s)) for s in range(4)]


@pytest.mark.parametrize("name,gt,test", CASES, ids=[c[0] for c in CASES])
def test_metrics_match_jax(name, gt, test):
    jg, jt = _subs(JSub, gt), _subs(JSub, test)
    tg, tt = _subs(TSub, gt), _subs(TSub, test)
    for (_, _, _, a), (_, _, _, b) in zip(gt, test):
        assert tmet.normalize_for_cer(a) == jmet.normalize_for_cer(a)
        assert tmet.levenshtein(a, b) == jmet.levenshtein(a, b)
        assert tmet.character_error_rate(a, b) \
            == jmet.character_error_rate(a, b)
    assert tmet.timing_iou(tg, tt) == jmet.timing_iou(jg, jt)
    regions_g = [(s.start, s.end) for s in jg]
    regions_t = [(s.start, s.end) for s in jt]
    total = max(s.end for s in jg + jt)
    assert tmet.frame_f1(regions_g, regions_t, total) \
        == jmet.frame_f1(regions_g, regions_t, total)
    assert _plain(tmet.boundary_drift(tg, tt)) \
        == _plain(jmet.boundary_drift(jg, jt))
    assert tmet.timing_offsets(tg, tt) == jmet.timing_offsets(jg, jt)
    assert tmet.temporal_order_score(tt) == jmet.temporal_order_score(jt)
    assert _plain(tmet.evaluate(tg, tt).to_dict()) \
        == _plain(jmet.evaluate(jg, jt).to_dict())


@pytest.mark.parametrize("name,gt,test", CASES, ids=[c[0] for c in CASES])
def test_matcher_and_provenance_match_jax(name, gt, test):
    jg, jt = _subs(JSub, gt), _subs(JSub, test)
    tg, tt = _subs(TSub, gt), _subs(TSub, test)
    jres = jmatch.match_subtitles(jg, jt)
    tres = tmatch.match_subtitles(tg, tt)
    assert tres.to_dict() == jres.to_dict()
    assert [(g.index, t.index) for g, t in tres.matched] \
        == [(g.index, t.index) for g, t in jres.matched]
    assert tres.similarities == jres.similarities
    assert [s.index for s in tres.missed] == [s.index for s in jres.missed]
    assert [s.index for s in tres.hallucinated] \
        == [s.index for s in jres.hallucinated]
    for (_, _, _, a), (_, _, _, b) in zip(gt, test):
        assert tmatch.text_similarity(a, b) == jmatch.text_similarity(a, b)
    assert tprov.build_provenance(tt, WINDOWS) \
        == jprov.build_provenance(jt, WINDOWS)
    assert [tprov.find_window(s, WINDOWS) for s in tt] \
        == [jprov.find_window(s, WINDOWS) for s in jt]
    assert tprov.window_analytics(tres, WINDOWS, tt) \
        == jprov.window_analytics(jres, WINDOWS, jt)


def _run_dir(tmp_path):
    """One run's artifacts on disk, as tests/test_bench_report.py and
    tests/test_forensic.py write them."""
    srt = tmp_path / "movie.ja.whisperjav.srt"
    save_srt(srt, [JSub(1, 0.5, 2.0, "こんばんは今日はいい天気"),
                   JSub(2, 5.0, 7.0, "ありがとうございます")])
    (tmp_path / "movie.transcribe.json").write_text(json.dumps({
        "windows": [
            {"scene": 0, "group": 0, "start": 0.4, "duration": 2.0,
             "segments": 1, "chars": 12, "avg_logprob": -0.3,
             "no_speech_prob": 0.1},
            {"scene": 1, "group": 0, "start": 10.0, "duration": 2.0,
             "segments": 0, "chars": 0, "avg_logprob": None,
             "no_speech_prob": 0.9},
            {"scene": 2, "group": 0, "start": 20.0, "duration": 2.0,
             "segments": 1, "chars": 8, "avg_logprob": -0.5,
             "no_speech_prob": 0.2},
            {"scene": 3, "group": 0, "start": 30.0, "duration": 2.0,
             "segments": 1, "chars": 9, "avg_logprob": -0.4,
             "no_speech_prob": 0.2}]}), encoding="utf-8")
    (tmp_path / "movie.whisperjav.json").write_text(json.dumps({
        "stats": {"scenes": 4, "groups": 4, "windows": 4, "rtf_x": 100.0,
                  "sanitization": {"total_removed": 1}}}),
        encoding="utf-8")
    save_srt(tmp_path / "movie.ja.whisperjav.artifacts.srt",
             [JSub(1, 20.2, 21.5, "[abnormally_fast_cps_44.0] あっ")])
    return srt


FORENSIC_GT = [(1, 0.5, 2.0, "こんばんは今日はいい天気"),
               (2, 5.0, 6.0, "窓の外は雨だ"),
               (3, 10.2, 11.0, "ねえ聞いて"),
               (4, 20.2, 21.0, "あっすごい"),
               (5, 30.2, 31.0, "もう帰るの")]


def _run_fields(run):
    d = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)}
    for k in ("subtitles", "removed"):
        d[k] = [(s.index, s.start, s.end, s.text) for s in d[k]]
    d["srt_path"] = str(d["srt_path"])
    return d


def test_loader_report_and_forensic_match_jax(tmp_path, capsys):
    srt = _run_dir(tmp_path)
    jrun, trun = jload.load_run(srt), tload.load_run(srt)
    assert _run_fields(trun) == _run_fields(jrun)
    assert trun.scene_spans == jrun.scene_spans
    solo = tmp_path / "solo.srt"
    save_srt(solo, [JSub(1, 0.0, 1.0, "a")])
    assert _run_fields(tload.load_run(solo)) \
        == _run_fields(jload.load_run(solo))

    jg, tg = _subs(JSub, FORENSIC_GT), _subs(TSub, FORENSIC_GT)
    janalysis, tanalysis = jrep.analyze(jg, [jrun]), trep.analyze(tg, [trun])
    assert _plain(tanalysis) == _plain(janalysis)
    jrep.print_summary(janalysis)
    want = capsys.readouterr().out
    trep.print_summary(tanalysis)
    assert capsys.readouterr().out == want
    assert trep.write_json_report(tanalysis, tmp_path / "t.json") \
        .read_bytes() == jrep.write_json_report(
            janalysis, tmp_path / "j.json").read_bytes()

    jrows, trows = jfor.loss_stage_rows(jg, jrun), tfor.loss_stage_rows(tg,
                                                                       trun)
    assert trows == jrows
    assert [r["loss_stage"] for r in trows] == [
        "matched", "coverage_loss", "model_empty", "sanitizer_removed",
        "text_lost"]
    assert tfor.summarize(trows) == jfor.summarize(jrows)
    assert tfor.write_forensic_csv(tmp_path / "t.csv", trows).read_bytes() \
        == jfor.write_forensic_csv(tmp_path / "j.csv", jrows).read_bytes()


def _without_timestamp(report):
    report = json.loads(json.dumps(report))
    report["provenance"].pop("timestamp")
    return report


@pytest.mark.parametrize("flags", [[], ["--full"], ["--forensic"]],
                         ids=["results", "full", "forensic"])
def test_bench_command_line_matches_jax(tmp_path, capsys, flags):
    """``whisperjav-torch-bench`` writes the report ``whisperjav-bench``
    writes, the provenance timestamp aside; the forensic CSVs are
    byte-identical."""
    srt = _run_dir(tmp_path)
    gt = tmp_path / "gt.srt"
    save_srt(gt, _subs(JSub, FORENSIC_GT))
    other = tmp_path / "other.srt"
    save_srt(other, _subs(JSub, _random_cues(7)))
    reports, csvs = [], []
    for main, tag in ((jcli.main, "j"), (tcli.main, "t")):
        argv = ["-g", str(gt), "-t", str(srt), str(other), "-o",
                str(tmp_path / f"{tag}.json")]
        if flags == ["--full"]:
            argv.append("--full")
        if flags == ["--forensic"]:
            argv += ["--forensic", str(tmp_path / f"{tag}.csv")]
        assert main(argv) == 0
        reports.append(json.loads((tmp_path / f"{tag}.json").read_text(
            encoding="utf-8")))
        if flags == ["--forensic"]:
            csvs.append((tmp_path / f"{tag}.csv").read_bytes())
    out = capsys.readouterr().out
    assert _without_timestamp(reports[1]) == _without_timestamp(reports[0])
    if csvs:
        assert csvs[1] == csvs[0] and b"loss_stage" in csvs[0]
        # the forensic summary each command printed
        dec, pos, printed = json.JSONDecoder(), 0, []
        while out[pos:].strip():
            pos += len(out[pos:]) - len(out[pos:].lstrip())
            obj, pos = dec.raw_decode(out, pos)
            printed.append(obj)
        assert len(printed) == 2 and printed[1] == printed[0]


def test_bench_stdout_matches_jax(tmp_path, capsys):
    gt, test = tmp_path / "gt.srt", tmp_path / "test.srt"
    save_srt(gt, [JSub(1, 0.0, 2.0, "こんにちは"), JSub(2, 3.0, 5.0, "世界")])
    save_srt(test, [JSub(1, 0.1, 2.1, "こんにちは"),
                    JSub(2, 3.2, 5.1, "世界です")])
    assert jcli.main(["-g", str(gt), "-t", str(test)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(["-g", str(gt), "-t", str(test)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _without_timestamp(got) == _without_timestamp(want)
    assert 0.0 < got["results"][str(test)]["cer"] < 0.5
