"""Unquantised cross-K/V (the JAX package's default, ``DecodeOptions()``)
in the port against the JAX package on the same weights and encoder
states: ``precompute_cross_kv`` with neither flag, ``cross_attention``
on K/V in the compute dtype (beams folded g = 1, 2), and ``decode_greedy``
/ ``decode_beam`` on the default options, token for token (f32 on the
CPU, tiny widths, real vocabulary). With int8 decoder weights and K/V in
the compute dtype no fused block runs, as in the JAX package
(``model.py:598-611``)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.quant import (
    fuse_qkv_weights, quantize_decoder_weights,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.pipelines import engine as te

_DIMS = dict(name="bf16kv-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
# f32 on both sides, sums in other orders: relative to the largest value
F32_TOL = 1e-5
# bf16 outputs of f32 sums in other orders: one bf16 step (2^-7 of the
# largest magnitude)
BF16_TOL = 2.0 ** -7


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
    params = jm.init_params(CFG, jax.random.PRNGKey(21))
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG)
    mel = np.random.default_rng(22).standard_normal(
        (3, CFG.n_mels, 3000)).astype(np.float32)
    xa = np.array(jm.encode(params, CFG, jnp.asarray(mel))[:, :448])
    return params, model, xa


def test_precompute_without_flags_matches_jax(setup):
    """(L, B, H, hd, T) K/V in the compute dtype and scales of one."""
    params, model, xa = setup
    ref = jm.precompute_cross_kv(params, CFG, jnp.asarray(xa))
    out = tm.precompute_cross_kv(model, torch.from_numpy(xa))
    assert out.k.dtype == torch.float32 and out.k.shape == (2, 3, 4, 16, 448)
    for name in ("k", "v"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name).numpy(), want,
                                   atol=F32_TOL * np.abs(want).max())
    for name in ("k_scale", "v_scale"):
        got = getattr(out, name)
        assert got.dtype == torch.float32 and got.shape == (2, 3, 4, 1, 1)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)))


def test_precompute_keeps_bf16(setup):
    """A bf16 model and bf16 states give bf16 K/V (the flagless path's
    compute dtype), equal to the f32 projection rounded once."""
    _, _, xa = setup
    m16 = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        CFG, jax.random.PRNGKey(21))), TCFG).to(torch.bfloat16)
    x16 = torch.from_numpy(xa).to(torch.bfloat16)
    out = tm.precompute_cross_kv(m16, x16)
    assert out.k.dtype == out.v.dtype == torch.bfloat16
    ref = tm.precompute_cross_kv(m16.float(), x16.float())
    for name in ("k", "v"):
        want = getattr(ref, name)
        np.testing.assert_allclose(
            getattr(out, name).float().numpy(), want.numpy(),
            atol=BF16_TOL * want.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_cross_attention_matches_jax(setup, g, dtype):
    """q (B*g, 1, H, hd) over one layer of unquantised K/V, beams folded:
    the JAX ``cross_attention`` on the same K/V (f32 within F32_TOL, bf16
    within BF16_TOL of the largest output)."""
    params, _, xa = setup
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cross = jm.precompute_cross_kv(params, CFG, jnp.asarray(xa))
    ck, cv = cross.k.astype(jdt), cross.v.astype(jdt)
    q = np.random.default_rng(23).standard_normal(
        (3 * g, 1, 4, 16)).astype(np.float32)
    ref = np.asarray(jm.cross_attention(
        jnp.asarray(q).astype(jdt), ck[1], cv[1], cross.k_scale[1],
        cross.v_scale[1]).astype(jnp.float32))
    out = tm.cross_attention(
        torch.from_numpy(q).to(tdt),
        tm.CrossKV(torch.from_numpy(np.array(ck.astype(jnp.float32))).to(
                       tdt),
                   torch.from_numpy(np.array(cv.astype(jnp.float32))).to(
                       tdt),
                   torch.from_numpy(np.array(cross.k_scale)),
                   torch.from_numpy(np.array(cross.v_scale))), 1)
    assert out.dtype == tdt and out.shape == ref.shape == (3 * g, 1, 4, 16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=tol * np.abs(ref).max())


def _same(ref, out):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    # f32 logits differ in the last bits; tokens do not
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), atol=1e-6)


@pytest.mark.parametrize("decode", ["decode_greedy", "decode_beam"])
def test_default_options_tokens_identical(setup, decode):
    """``decode_greedy`` on ``DecodeOptions()`` and ``decode_beam`` on its
    own default (``beam_size=2``): the whole 224-token budget."""
    params, model, xa = setup
    kw = {"beam_size": 2} if decode == "decode_beam" else {}
    jo, to = jd.DecodeOptions(**kw), td.DecodeOptions(**kw)
    assert not (to.cross_kv_int8 or to.cross_kv_int4)
    ref = getattr(jd, decode)(params, CFG, jnp.asarray(xa), jo)
    out = getattr(td, decode)(model, torch.from_numpy(xa), to)
    _same(ref, out)


@pytest.mark.parametrize("beam_size", [1, 2])
def test_balanced_options_on_unquantised_kv_tokens_identical(setup,
                                                             beam_size):
    """The balanced sensitivity's logit rules and beam patience on K/V in
    the compute dtype."""
    params, model, xa = setup
    kw = dict(max_new_tokens=24, repetition_penalty=1.5,
              no_repeat_ngram_size=3, patience=1.2, beam_size=beam_size)
    decode = "decode_beam" if beam_size > 1 else "decode_greedy"
    ref = getattr(jd, decode)(params, CFG, jnp.asarray(xa),
                              jd.DecodeOptions(**kw))
    out = getattr(td, decode)(model, torch.from_numpy(xa),
                              td.DecodeOptions(**kw))
    _same(ref, out)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_fused_blocks_only_on_int8_kv(setup, monkeypatch, int8_kv):
    """int8 decoder weights: single steps over int8 K/V go through the
    three fused blocks; over K/V in the compute dtype none runs (a spy
    counts their calls), and the tokens are finite and well formed."""
    _, _, xa = setup
    model = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        CFG, jax.random.PRNGKey(21))), TCFG)
    fuse_qkv_weights(model)
    quantize_decoder_weights(model)
    calls = []
    for name in ("self_block", "cross_block", "mlp_block"):
        orig = getattr(tm, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tm, name, spy)
    opts = td.DecodeOptions(max_new_tokens=4, cross_kv_int8=int8_kv,
                            with_timestamps=False)
    out = td.decode_greedy(model, torch.from_numpy(xa), opts)
    assert out.tokens.shape == (3, 4)
    assert np.isfinite(out.avg_logprob.numpy()).all()
    if int8_kv:
        assert calls.count("cross_block") == calls.count("self_block") >= 2
    else:
        assert calls == []


def test_engine_default_options_are_the_jax_engines():
    """``TranscriptionEngine()``'s default options equal the JAX engine's
    (``DecodeOptions()``: K/V in the compute dtype)."""
    def default(cls):
        return inspect.signature(cls.__init__).parameters["options"].default
    want = default(je.TranscriptionEngine)
    got = default(te.TranscriptionEngine)
    assert got == td.DecodeOptions(**dataclasses.asdict(want))
    assert got == td.DecodeOptions()
