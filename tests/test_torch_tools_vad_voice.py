"""The port's ``vad_analyser`` and ``voice_classifier`` against the JAX
package's on the CPU: equal analyser reports on the energy backends (the
energy VAD and the flagless silero probability), and a voice classifier
that, from the JAX init carried across, trains 20 full-batch Adam steps
to the JAX loss (within 1e-5 relative) and the JAX predictions; model
files cross both ways."""

import json

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.srt import Subtitle, save_srt
from whisperjav_tpu.tools import vad_analyser as jva
from whisperjav_tpu.tools import voice_classifier as jvc
from whisperjav_tpu_torch.tools import vad_analyser as tva
from whisperjav_tpu_torch.tools import voice_classifier as tvc

SR = 16000
LOSS_TOL_REL = 1e-5


def speech_like(duration_s, seed=0, freq=180.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * freq * t) * (
        1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _audio():
    gap = np.zeros(SR, np.float32)
    return np.concatenate([speech_like(2.0), gap, speech_like(2.5, 1, 220),
                           gap, gap, speech_like(1.5, 2, 160)])


# ---------------------------------------------------------------- analyser

@pytest.mark.parametrize("backends,with_gt", [
    (("energy",), True), (("energy", "silero"), True),
    (("energy", "silero"), False)], ids=["energy-gt", "both-gt", "both"])
def test_vad_analyser_matches_jax(tmp_path, backends, with_gt):
    gt = None
    if with_gt:
        gt = tmp_path / "gt.srt"
        save_srt(gt, [Subtitle(1, 0.0, 2.0, "a"),
                      Subtitle(2, 3.0, 5.5, "b"),
                      Subtitle(3, 7.5, 9.0, "c")])
    audio = _audio()
    want = jva.analyse(audio, SR, backends=backends, gt_srt=gt,
                       report_path=tmp_path / "j.json")
    got = tva.analyse(audio, SR, backends=backends, gt_srt=gt,
                      report_path=tmp_path / "t.json", device="cpu")
    assert json.loads(json.dumps(got, default=str)) \
        == json.loads(json.dumps(want, default=str))
    assert (tmp_path / "t.json").read_bytes() \
        == (tmp_path / "j.json").read_bytes()


def test_region_metrics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = np.sort(rng.uniform(0, 30, (6, 2)), axis=1).round(2)
        b = np.sort(rng.uniform(0, 30, (5, 2)), axis=1).round(2)
        gt, test = [tuple(r) for r in a], [tuple(r) for r in b]
        assert tva.segment_iou(gt, test) == jva.segment_iou(gt, test)
        assert tva.miss_fa_rates(gt, test) == jva.miss_fa_rates(gt, test)
        assert tva.boundary_drift_regions(gt, test) \
            == jva.boundary_drift_regions(gt, test)
        reports = [{"backend": "x", "_regions": gt},
                   {"backend": "y", "_regions": test}]
        assert tva.agreement_matrix(reports, 30.0) \
            == jva.agreement_matrix(reports, 30.0)


# ---------------------------------------------------------------- classifier

def _tone(freq, seconds=1.0, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.4 * np.sin(2 * np.pi * freq * t) + noise * rng.standard_normal(
        t.size)
    return x.astype(np.float32)


def _dataset():
    clips = ([_tone(150 + 10 * i, seed=i) for i in range(4)]
             + [_tone(2000 + 100 * i, seed=10 + i) for i in range(4)])
    labels = np.asarray([0] * 4 + [1] * 4, np.int32)
    return clips, labels


def test_clip_features_match_jax():
    for clip in _dataset()[0][::3]:
        np.testing.assert_array_equal(tvc.clip_features(clip, SR),
                                      jvc.clip_features(clip, SR))


def test_training_from_the_jax_init_matches_jax():
    clips, labels = _dataset()
    feats = np.stack([jvc.clip_features(c, SR) for c in clips])
    seed, hidden, steps = 3, 16, 20
    jparams, jloss = jvc.train(feats, labels, 2, hidden=hidden,
                               steps=steps, seed=seed)
    init = tvc.params_from_jax(jax.tree.map(np.asarray, jvc.init_mlp(
        jax.random.PRNGKey(seed), [feats.shape[1], hidden, 2])))
    model, loss = tvc.train(feats, labels, 2, hidden=hidden, steps=steps,
                            device="cpu", init=init)
    assert abs(loss - jloss) <= LOSS_TOL_REL * abs(jloss)
    probe = np.stack([tvc.clip_features(_tone(f, seed=50 + i), SR)
                      for i, f in enumerate((160, 400, 1200, 2100))])
    want = jvc.predict(jparams, probe)
    got = tvc.predict(model, probe)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_model_files_cross(tmp_path):
    jparams = jvc.init_mlp(jax.random.PRNGKey(0), [6, 4, 2])
    labels = {0: "a", 1: "b"}
    x = np.random.default_rng(1).standard_normal((3, 6)).astype(np.float32)
    want = np.asarray(jvc.mlp_logits(jparams, x))
    # JAX file -> port
    path = jvc.save_model(tmp_path / "j.npz", jparams, labels)
    model, id2label = tvc.load_model(path)
    assert id2label == labels
    got = tvc.mlp_logits(model, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # port file -> JAX
    path = tvc.save_model(tmp_path / "t.npz", model, labels)
    restored, id2label = jvc.load_model(path)
    assert id2label == labels
    np.testing.assert_array_equal(np.asarray(jvc.mlp_logits(restored, x)),
                                  want)
    for a, b in zip(np.load(tmp_path / "t.npz").values(),
                    np.load(tmp_path / "j.npz").values()):
        np.testing.assert_array_equal(a, b)


def test_command_line_trains_and_infers(tmp_path, capsys):
    clips, labels = _dataset()
    names = {}
    for i, (clip, y) in enumerate(zip(clips, labels)):
        name = f"c{i}.wav"
        write_wav(tmp_path / name, clip, SR)
        names[name] = "low" if y == 0 else "high"
    (tmp_path / "labels.json").write_text(json.dumps(names))
    model = tmp_path / "clf.npz"
    assert tvc.main(["train", "--data", str(tmp_path), "--labels",
                     str(tmp_path / "labels.json"), "--out", str(model),
                     "--steps", "200", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["classes"] == ["high", "low"] and out["clips"] == 8
    probe = tmp_path / "probe.wav"
    write_wav(probe, _tone(160, seed=99), SR)
    assert tvc.main(["infer", "--model", str(model), str(probe),
                     "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result[str(probe)][0][0] == "low"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tvc.main(["infer", "--model", str(model), str(probe)])
