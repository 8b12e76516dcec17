"""Word alignment in the port vs the JAX package (f32 on the CPU): the
teacher-forced cross-attention maps within 1e-5, identical word spans
(float and int8 decoder weights, fused q/k/v), the monotonic aligner,
and engine refinement with word_timestamps=True giving the JAX engine's
segment times on the inline and on the deferred-retry path."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.qwen.aligner import monotonic_align as j_align
from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper import quant as jq
from whisperjav_tpu.models.whisper import word_align as jwa
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.parallel.batching import Window as JWindow
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu_torch.models.qwen.aligner import monotonic_align
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper import word_align as twa
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.quant import (
    fuse_qkv_weights, quantize_decoder_weights,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.parallel.batching import Window
from whisperjav_tpu_torch.pipelines import engine as te

_DIMS = dict(name="torch-wa-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = jm.init_params(CFG, jax.random.PRNGKey(3))
    mel = np.random.default_rng(0).standard_normal(
        (2, CFG.n_mels, 3000)).astype(np.float32)
    xa = np.array(jm.encode(params, CFG, jnp.asarray(mel))[:, :448])
    return params, xa


def _trees(params, int8):
    """The engine's tree in both packages: fused q/k/v, int8 decoder
    weights when asked."""
    tree = jq.fuse_qkv_weights(params)
    model = fuse_qkv_weights(params_from_jax(jax.tree.map(np.asarray,
                                                          params), TCFG))
    if int8:
        tree = jq.quantize_decoder_weights(tree)
        quantize_decoder_weights(model)
    return tree, model


@pytest.mark.parametrize("heads", [None, ((1, 0), (1, 3), (0, 2))])
def test_default_head_mask_matches(heads):
    cfg = dataclasses.replace(CFG, alignment_heads=heads)
    tcfg = dataclasses.replace(TCFG, alignment_heads=heads)
    np.testing.assert_array_equal(twa.default_head_mask(tcfg),
                                  jwa.default_head_mask(cfg))


@pytest.mark.parametrize("int8", [False, True])
def test_cross_attention_maps_match_jax(setup, int8):
    """(B, S, T_a) attention mass within 1e-5; a launch counted per
    pass."""
    params, xa = setup
    tree, model = _trees(params, int8)
    toks = np.array([[CFG.sot, 100, 200, 300, 400, CFG.eot],
                     [CFG.sot, 7, 8, CFG.eot, CFG.eot, CFG.eot]], np.int32)
    mask = jwa.default_head_mask(CFG)
    want = np.asarray(jwa.cross_attention_maps(
        tree, CFG, jnp.asarray(toks), jnp.asarray(xa), jnp.asarray(mask)))
    before = twa.cross_attention_maps.launches
    got = twa.cross_attention_maps(model, torch.from_numpy(toks).long(),
                                   torch.from_numpy(xa),
                                   torch.from_numpy(mask)).numpy()
    assert twa.cross_attention_maps.launches == before + 1
    assert got.shape == want.shape == (2, 6, 448)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("row", [
    [100, 200, 300, 400],
    ["ts0", 100, 200, "ts20", "ts20", 5000, 6000, 7000, "ts60"],
    list(range(1000, 1070)),          # past one 64-token length bucket
])
def test_word_spans_identical(setup, int8, row):
    params, xa = setup
    tree, model = _trees(params, int8)
    gen = np.array([CFG.timestamp_begin + int(t[2:]) if isinstance(t, str)
                    else t for t in row] + [CFG.eot] * 3)
    want = jwa.word_timestamps(tree, CFG, jnp.asarray(xa[:1]), gen,
                               audio_duration=8.5)
    got = twa.word_timestamps(model, torch.from_numpy(xa[:1]), gen,
                              audio_duration=8.5)
    assert len(got) == len(want) == sum(not isinstance(t, str) for t in row)
    assert [(s.text, s.start, s.end, s.tokens) for s in got] == \
        [(s.text, s.start, s.end, s.tokens) for s in want]


@pytest.mark.parametrize("n,t", [(1, 1), (3, 40), (17, 120), (9, 5)])
def test_monotonic_align_matches(n, t):
    lp = np.log(np.random.default_rng(n * t).dirichlet(np.ones(t), size=n))
    assert monotonic_align(lp) == j_align(lp)


def _engines(params, temperatures, logprob_threshold):
    """The two engines on the same weights: greedy (argmax on every rung,
    so the rungs past the first decode the same tokens in both), word
    timestamps on, every row gated by ``logprob_threshold``."""
    gates = dict(logprob_threshold=logprob_threshold,
                 no_speech_threshold=1.0, temperatures=temperatures)
    opts = dict(max_new_tokens=12, cross_kv_int8=True, assume_greedy=True)
    ref = je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(**opts),
        thresholds=je.QualityThresholds(**gates), batch_size=2,
        compute_dtype=jnp.float32, word_timestamps=True)
    out = te.TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(**opts),
        thresholds=te.QualityThresholds(**gates), batch_size=2,
        device="cpu", compute_dtype=torch.float32, word_timestamps=True)
    return ref, out


def _windows(cls):
    rng = np.random.default_rng(1)
    return [cls((0.2 * rng.standard_normal(int(16000 * d))).astype(
        np.float32), 0.0, d, 0, i) for i, d in enumerate((3.0, 7.5, 4.2))]


def _times(results):
    return [[(s.start, s.end, s.text, list(s.tokens)) for s in segs]
            for _, segs in results]


def test_engine_refinement_matches_on_both_paths(setup, monkeypatch):
    """Inline: a one-rung ladder. Deferred: every row fails the gate
    (logprob threshold 0), goes to the file's pool and is refined there
    over freshly encoded states. Both give the JAX engine's segments, and
    the same segments as each other."""
    params, _ = setup
    passes = []
    real = twa.word_timestamps

    def counting(*a, **kw):
        passes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(te, "word_timestamps", counting)
    got = {}
    for path, temps, th in (("inline", (0.0,), -10.0),
                            ("deferred", (0.0, 0.2), 0.0)):
        ref, out = _engines(params, temps, th)
        want = _times(ref.transcribe_windows(_windows(JWindow)))
        n0 = len(passes)
        got[path] = _times(out.transcribe_windows(_windows(Window)))
        assert len(passes) > n0, path
        assert got[path] == want, path
        assert any(segs for segs in got[path])
    assert got["inline"] == got["deferred"]
    # the alignment moved bounds: without it the segments differ
    unrefined = _engines(params, (0.0,), -10.0)[1]
    unrefined.word_timestamps = False
    assert _times(unrefined.transcribe_windows(_windows(Window))) \
        != got["inline"]
