"""The port's Qwen3-ASR against the benchmark's plain float32 reference
(``benchmark/reference/qwen3_asr.py``, loaded by path) on the CPU, at
the test widths (``qwen3-asr-test``) on the benchmark's seeded weights
(``benchmark/h100bench/qwen_weights.py``: biases and norm scales that
are not trivial): the tower's embeddings, the prefill's logits, every
column-mode step's logits through the cache against the reference's one
full forward, and the penalised log-probabilities and greedy choices of
the tokens ``generate`` served. A step with one fault, or a bias or a
norm scale dropped or swapped, fails the tolerance.

Tolerances: both sides compute in float32 from the same weights (the
reference takes the int8 codes back to float32, the port scales the
int8 product), so only the order of the sums differs: activations and
logits agree within 1e-4 of their largest magnitude (measured: ~1e-6);
a faulty step misses by a hundred times that or more."""

import ast
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperjav_tpu_torch.models.qwen import model as qm
from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
    prepare_params,
)
from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
PATH = BENCH / "reference" / "qwen3_asr.py"
CFG = qm.QWEN_SIZES["qwen3-asr-test"]
REL = 1e-4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(PATH, "qwen3_asr_reference")
drawer = _load(BENCH / "h100bench" / "qwen_weights.py", "qwen_weights")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    """The reference's tree of the seeded draw, and the port's model of
    the same draw after the generator's post-load step (fused q/k/v,
    int8 LM and head)."""
    tree = drawer.draw(dataclasses.asdict(CFG), 11, "cpu")
    return tree, prepare_params(qm.QwenASR(CFG, _copy(tree)))


@pytest.fixture(scope="module")
def audio():
    """Two rows of 8 s (two attention windows), the second with 3 s of
    speech-like tone and noise and the rest zero padding."""
    rng = np.random.default_rng(5)
    t = np.arange(8 * 16000) / 16000
    a = (0.2 * np.sin(2 * np.pi * 180 * t)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    b = a.copy()
    b[3 * 16000:] = 0.0
    return np.stack([a, b])


@pytest.fixture(scope="module")
def embeddings(weights, audio):
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=CFG.n_mels)
    with torch.no_grad():
        return qm.encode_audio(weights[1], mel)


def _close(out, want, rel=REL):
    out, want = out.detach().double(), want.detach().double()
    assert out.shape == want.shape
    err = float((out - want).abs().max() / want.abs().max())
    assert err <= rel, err


def _model_dict():
    return dataclasses.asdict(CFG)


def test_tower_embeddings(weights, audio, embeddings):
    tree, _ = weights
    with torch.no_grad():
        for row in range(2):
            mel = ref.log_mel(torch.from_numpy(audio[row:row + 1]),
                              CFG.n_mels)[0]
            want = ref.tower(tree["audio"], mel, _model_dict())
            _close(embeddings[row], want)
            assert ref.audio_err(embeddings[row], want) < REL


def _reference_logits(tree, emb, served):
    """The reference's full forward over [emb, BOS, served[:-1]]: the
    logits before each served token."""
    w = ref.lm_weights(tree)
    m = _model_dict()
    ids = torch.tensor([CFG.bos_id] + list(served[:-1]))
    x = torch.cat([emb, w["tok_emb"][ids]])
    with torch.no_grad():
        hidden = ref.lm_hidden(w, m, x)[emb.shape[0]:]
    return hidden @ w["head"]


def test_prefill_logits(weights, embeddings):
    tree, model = weights
    emb = embeddings[:1]
    bos = model.tok_emb[torch.tensor([[CFG.bos_id]])]
    cache = qm.LMCache.zeros(CFG, 1, emb.shape[1] + 1, torch.float32, "cpu")
    with torch.no_grad():
        logits, _ = qm.lm_step(model, torch.cat([emb, bos], 1), 0, cache)
        w = ref.lm_weights(tree)
        want = ref.lm_hidden(w, _model_dict(), torch.cat(
            [emb[0], w["tok_emb"][[CFG.bos_id]]])) @ w["head"]
    _close(logits[0], want)


def _step_logits(model, emb, served):
    """The port's logits before each served token: the prefill over
    [emb, BOS], then one column-mode step a token through the cache."""
    p = emb.shape[1]
    cache = qm.LMCache.zeros(CFG, 1, p + 1 + len(served), torch.float32,
                             "cpu")
    bos = model.tok_emb[torch.tensor([[CFG.bos_id]])]
    out = []
    with torch.no_grad():
        logits, cache = qm.lm_step(model, torch.cat([emb, bos], 1), 0, cache)
        out.append(logits[0, -1])
        for i, tok in enumerate(served[:-1]):
            logits, cache = qm.lm_step(model, model.tok_emb[
                torch.tensor([[tok]])], p + 1 + i, cache)
            out.append(logits[0, 0])
    return torch.stack(out)


SERVED = [17, 4001, 17, 256, 3, 999, 17, 2048, 5, 77, 4095, 12]


def test_every_step_through_the_cache(weights, embeddings):
    tree, model = weights
    emb = embeddings[1:2]
    _close(_step_logits(model, emb, SERVED),
           _reference_logits(tree, emb[0], SERVED))


def _late_column(monkeypatch):
    """A step writes its new K/V column one slot late."""
    inner = qm.lm_step

    def step(model, x, pos, cache):
        logits, cache = inner(model, x, pos, cache)
        if x.shape[1] == 1 and pos + 1 < cache.k.shape[2]:
            for c in cache:
                c[:, :, pos + 1] = c[:, :, pos]
                c[:, :, pos] = 0.0
        return logits, cache
    monkeypatch.setattr(qm, "lm_step", step)


def _rope_one_late(monkeypatch):
    """The rotary angles of a step taken one position late."""
    inner = qm.rope_angles

    def angles(positions, hd, theta):
        shift = 1 if positions.numel() == 1 else 0
        return inner(positions + shift, hd, theta)
    monkeypatch.setattr(qm, "rope_angles", angles)


@pytest.mark.parametrize("fault", [_late_column, _rope_one_late],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_faulty_step_misses(weights, embeddings, fault, monkeypatch):
    tree, model = weights
    emb = embeddings[1:2]
    want = _reference_logits(tree, emb[0], SERVED)
    fault(monkeypatch)
    got = _step_logits(model, emb, SERVED)
    err = float((got - want).abs().max() / want.abs().max())
    assert err > 100 * REL, err


def _swap_qk_norm(model):
    blocks = model.blocks
    return {"q_norm": blocks["k_norm"], "k_norm": blocks["q_norm"]}, blocks


def _no_ln_f(model):
    return {"ln_f": torch.ones_like(model["ln_f"])}, model


def _no_tower_q_bias(model):
    blocks = model.audio["blocks"]
    return {"bq": torch.zeros_like(blocks["bq"])}, blocks


@pytest.mark.parametrize("fault", [_swap_qk_norm, _no_ln_f,
                                   _no_tower_q_bias],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_misplaced_weight_misses(weights, audio, embeddings, fault,
                                   monkeypatch):
    """The draw's biases and norm scales are not trivial, so a port that
    swaps, drops or misplaces one parts from the reference."""
    tree, model = weights
    leaves, node = fault(model)
    for name, value in leaves.items():
        monkeypatch.setattr(node, name, torch.nn.Parameter(
            value.detach(), requires_grad=False))
    if fault is _no_tower_q_bias:
        mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=CFG.n_mels)
        with torch.no_grad():
            got, want = qm.encode_audio(model, mel)[1], embeddings[1]
    else:
        emb = embeddings[1:2]
        got = _step_logits(model, emb, SERVED)
        want = _reference_logits(tree, emb[0], SERVED)
    err = float((got - want).abs().max() / want.abs().max())
    # measured 4e-3-8e-3, sound ~1e-6
    assert err > 10 * REL, err


def test_served_logprobs(weights, audio):
    """``generate``'s average log-probability of what it served, with the
    repetition penalty, against the reference's on the port's
    embeddings and on its own whole path from the audio."""
    tree, model = weights
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=CFG.n_mels)
    audio_len = CFG.audio_tokens_for(mel.shape[-1])
    res = qm.generate(model, mel, max_new=40, audio_len=audio_len,
                      repetition_penalty=1.1)
    with torch.no_grad():
        emb = qm.encode_audio(model, mel)
    m = _model_dict()
    w = ref.lm_weights(tree)
    repeats, leads = 0, []
    for row in range(2):
        n = int(res.length[row])
        served = res.tokens[row, :min(n + 1, 40)].numpy()
        repeats += len(served) - len(set(served.tolist()))
        total = float(res.avg_logprob[row]) * (n + 1)
        own = ref.served_logprob(w, m, emb[row], served, 1.1, block=16)
        mel_r = ref.log_mel(torch.from_numpy(audio[row:row + 1]), CFG.n_mels)
        with torch.no_grad():
            path = ref.served_logprob(
                w, m, ref.tower(tree["audio"], mel_r[0], m), served, 1.1)
        assert abs(total - own) / (n + 1) < 1e-5
        assert abs(total - path) / (n + 1) < 1e-5
        # every greedy choice is the reference's own, under the penalty
        read = ref.read_path(w, m, emb[row], served, 1.1, block=16)
        assert read["sum"] == pytest.approx(own, abs=1e-9)
        assert read["lead"] < 1e-4
        leads.append(ref.read_path(w, m, emb[row], served, 1.0)["lead"])
        # without the penalty the sums part
        plain = ref.served_logprob(w, m, emb[row], served, 1.0)
        assert abs(plain - own) / (n + 1) > 1e-3 or not repeats
    assert repeats, "no id repeats: the penalty was not exercised"
    # judged without the penalty, the choices it made fall short
    assert max(leads) > 1e-2


def test_reference_is_plain():
    names = set()
    for node in ast.walk(ast.parse(PATH.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}, names
