"""Vocab-sliced decoding in the port vs the JAX engine (f32 on the CPU):
greedy and beam-2 tokens identical on float and on int8 decoder weights,
the int8 lm head quantised from the sliced embedding (bit for bit the
JAX engine's), a remapped prompt, and word alignment through
SubsetTokenizerAdapter giving the JAX engine's segments."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.vocab_subset import synthetic_text_ids
from whisperjav_tpu.parallel.batching import Window as JWindow
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.vocab_subset import (
    SlicedVocabConfig, synthetic_text_ids as t_synthetic_text_ids,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.parallel.batching import Window
from whisperjav_tpu_torch.pipelines import engine as te

_DIMS = dict(name="torch-vocab-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
BALANCED = dict(max_new_tokens=16, cross_kv_int8=True,
                repetition_penalty=1.5, no_repeat_ngram_size=3,
                patience=1.2, best_of=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jm.init_params(CFG, jax.random.PRNGKey(11))


def _audio(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, 480000), np.float32)
    for i in range(batch):
        n = int((4.0 + 3 * i) * 16000)
        t = np.arange(n) / 16000.0
        out[i, :n] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                      + 0.05 * rng.standard_normal(n))
    return out


def _engines(params, keep, beam, int8, prompt=(), **kw):
    th = dict(temperatures=(0.0,))
    ref = je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(beam_size=beam, **BALANCED),
        thresholds=je.QualityThresholds(**th), batch_size=3,
        compute_dtype=jnp.float32, int8_weights=int8, vocab_subset=keep,
        prompt_tokens=prompt, **kw)
    out = te.TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(beam_size=beam, **BALANCED),
        thresholds=te.QualityThresholds(**th), batch_size=3, device="cpu",
        compute_dtype=torch.float32, int8_weights=int8, vocab_subset=keep,
        prompt_tokens=prompt, **kw)
    return ref, out


def test_synthetic_subset_is_the_jax_one():
    for n in (1, 100, 16384, 60000):
        np.testing.assert_array_equal(t_synthetic_text_ids(TCFG, n),
                                      synthetic_text_ids(CFG, n))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("beam", [1, 2])
def test_sliced_decoding_token_identical(params, beam, int8):
    keep = synthetic_text_ids(CFG, 8000)
    ref, out = _engines(params, keep, beam, int8)
    audio = _audio()
    want = ref.decode_batch(audio, 0.0, 0)
    got = out.decode_encoded(out.encode_batch(audio), 0.0, 0)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))
    np.testing.assert_allclose(got.avg_logprob, np.asarray(want.avg_logprob),
                               atol=1e-4)
    # full-vocab ids out, all in the subset or the special tail
    kept = set(keep.tolist()) | set(range(CFG.eot, CFG.n_vocab))
    assert set(got.tokens.ravel().tolist()) <= kept
    assert isinstance(out.model.config, SlicedVocabConfig)
    assert out.model.decoder.tok_emb.shape[0] == len(keep) + \
        CFG.n_vocab - CFG.eot
    assert out.config.n_vocab == CFG.n_vocab


def test_int8_lm_head_is_quantised_at_subset_size(params):
    """The tied embedding is sliced before quantisation: the int8 lm head
    has one column per kept id, with the codes and scales of the JAX
    package's quantiser on the sliced embedding (bit for bit) and the
    JAX engine's codes (its jitted quantiser rounds some scales one ulp
    apart)."""
    from whisperjav_tpu.models.whisper.quant import _quantize
    keep = synthetic_text_ids(CFG, 3000)
    ref, out = _engines(params, keep, 1, True)
    lm = out.model.decoder.lm_head_q
    n_sub = len(keep) + CFG.n_vocab - CFG.eot
    assert lm.q.shape == (64, n_sub)
    sub_ids = np.concatenate([keep, np.arange(CFG.eot, CFG.n_vocab)])
    want = _quantize(jnp.asarray(params["decoder"]["tok_emb"])[sub_ids].T)
    np.testing.assert_array_equal(lm.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(lm.s.numpy(), np.asarray(want["s"]))
    engine_lm = ref.params["decoder"]["lm_head_q"]
    np.testing.assert_array_equal(lm.q.numpy(), np.asarray(engine_lm["q"]))
    np.testing.assert_allclose(lm.s.numpy(), np.asarray(engine_lm["s"]),
                               rtol=2.5e-7, atol=0)


def test_prompt_is_remapped(params):
    """Prompt ids decode in subset space; an id outside the subset is
    dropped, as in the JAX engine."""
    keep = synthetic_text_ids(CFG, 5000)
    prompt = (int(keep[10]), int(keep[20]) + 1, int(keep[30]))
    ref, out = _engines(params, keep, 1, False, prompt=prompt)
    assert len(out.prompt_tokens) == 2
    audio = _audio(batch=2, seed=1)
    want = ref.decode_batch(audio, 0.0, 0)
    got = out.decode_encoded(out.encode_batch(audio), 0.0, 0)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("int8", [False, True])
def test_word_alignment_through_the_subset(params, int8):
    """transcribe_windows with word timestamps under a slice: the same
    segments, refined times and texts as the JAX engine."""
    keep = synthetic_text_ids(CFG, 8000)
    ref, out = _engines(params, keep, 2, int8, word_timestamps=True)
    audio = _audio()
    durs = (4.0, 7.0, 10.0)

    def windows(cls):
        return [cls(audio[i, :int(d * 16000)], 0.0, d, 0, i)
                for i, d in enumerate(durs)]

    def segs(results):
        return [[(s.start, s.end, s.text, list(s.tokens)) for s in ss]
                for _, ss in results]

    want = segs(ref.transcribe_windows(windows(JWindow)))
    got = segs(out.transcribe_windows(windows(Window)))
    assert any(got)
    assert got == want
