"""The port's decode loops vs the JAX package: greedy, beam and sampled
decoding give the same tokens on the same weights and encoder states,
and extract_segments the same segments (f32 on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="torch-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
# the balanced sensitivity's decoding options, with a short budget
BALANCED = dict(max_new_tokens=24, cross_kv_int8=True,
                repetition_penalty=1.5, no_repeat_ngram_size=3,
                patience=1.2, best_of=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = jm.init_params(CFG, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG)
    mel = np.random.default_rng(2).standard_normal(
        (3, CFG.n_mels, 3000)).astype(np.float32)
    xa = np.array(jm.encode(params, CFG, jnp.asarray(mel))[:, :448])
    return params, model, xa


def _opts(**kw):
    return (jd.DecodeOptions(**BALANCED, **kw),
            td.DecodeOptions(**BALANCED, **kw))


def _same(ref, out):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    # f32 logits differ in the last bits; tokens do not
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), atol=1e-6)


def test_options_mirror_jax():
    assert ([f.name for f in dataclasses.fields(td.DecodeOptions)]
            == [f.name for f in dataclasses.fields(jd.DecodeOptions)])
    assert td.DecodeOptions() == td.DecodeOptions(
        **dataclasses.asdict(jd.DecodeOptions()))


def test_greedy_tokens_identical(setup):
    params, model, xa = setup
    jo, to = _opts()
    ref = jd.decode_greedy(params, CFG, jnp.asarray(xa), jo)
    out = td.decode_greedy(model, torch.from_numpy(xa), to)
    _same(ref, out)


def test_beam2_tokens_identical(setup):
    params, model, xa = setup
    jo, to = _opts(beam_size=2)
    ref = jd.decode_beam(params, CFG, jnp.asarray(xa), jo)
    out = td.decode_beam(model, torch.from_numpy(xa), to)
    _same(ref, out)


@pytest.mark.parametrize("beam_size", [1, 2])
def test_int4_cross_kv_tokens_identical(setup, beam_size):
    """Nibble-packed int4 cross-K/V (``cross_kv_int4``, over int8): the
    JAX package's tokens, greedy and with the beam."""
    params, model, xa = setup
    jo, to = _opts(beam_size=beam_size, cross_kv_int4=True)
    decode = "decode_beam" if beam_size > 1 else "decode_greedy"
    ref = getattr(jd, decode)(params, CFG, jnp.asarray(xa), jo)
    out = getattr(td, decode)(model, torch.from_numpy(xa), to)
    _same(ref, out)


def test_sampled_rung_identical_with_jax_noise(setup):
    """The port is fed the gumbel noise that decode.py's loop draws from
    its key: split once per step, gumbel from the subkey."""
    params, model, xa = setup
    jo, to = _opts()
    seed, temperature = 5, 0.6
    key = jax.random.PRNGKey(seed)
    noise = []
    for _ in range(jo.max_new_tokens):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (xa.shape[0], CFG.n_vocab), jnp.float32))))
    ref = jd.decode_greedy(params, CFG, jnp.asarray(xa), jo,
                           temperature=temperature,
                           rng=jax.random.PRNGKey(seed))
    out = td.decode_greedy(model, torch.from_numpy(xa), to,
                           temperature=temperature,
                           gumbel=lambda step: noise[step])
    _same(ref, out)


def test_sampling_needs_a_noise_source(setup):
    _, model, xa = setup
    with pytest.raises(ValueError):
        td.decode_greedy(model, torch.from_numpy(xa), _opts()[1],
                         temperature=0.4)


def test_extract_segments_identical(setup):
    params, _, xa = setup
    jo, to = _opts(beam_size=2)
    tokens = np.asarray(jd.decode_beam(params, CFG, jnp.asarray(xa),
                                       jo).tokens)
    ts = CFG.timestamp_begin
    rows = list(tokens) + [
        np.array([ts, 100, 200, ts + 40, ts + 40, 300, CFG.eot]),
        np.array([500, ts + 10, ts + 11, 600, 700])]
    for row in rows:
        ref = jd.extract_segments(row, CFG, jo, 8.96, -0.5, 0.1)
        out = td.extract_segments(row, TCFG, to, 8.96, -0.5, 0.1)
        assert [dataclasses.asdict(s) for s in out] == \
            [dataclasses.asdict(s) for s in ref]
