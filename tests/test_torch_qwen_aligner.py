"""The port's forced aligner vs the JAX package on the CPU, at the
default ``AlignerConfig`` widths (d=192, 4 + 4 layers, 6 heads), from the
JAX init's weights carried across with ``params_from_jax`` and seeded
numpy audio.

Tolerances: the similarity logits (f32 on both sides, sums in other
orders) within 1e-4 of their largest magnitude; spans identical."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.qwen import aligner as ja
from whisperjav_tpu.ops.mel import log_mel_spectrogram as jax_mel
from whisperjav_tpu_torch.models.qwen import aligner as ta

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def aligners():
    """The JAX ForcedAligner (default config, PRNGKey(0)) and the port's
    on the same weights, on the CPU."""
    jal = ja.ForcedAligner()
    params = ta.params_from_jax(jax.tree.map(np.asarray, jal.params),
                                ta.AlignerConfig())
    return jal, ta.ForcedAligner(params=params, device="cpu")


def _speech(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.05 * rng.standard_normal(t.size))
    return x.astype(np.float32)


def _batch(lens, bucket_s):
    audio = np.zeros((len(lens), int(bucket_s * SR)), np.float32)
    for r, n in enumerate(lens):
        audio[r, :n] = _speech(n / SR, r)[:n]
    return audio


def test_config_mirrors_jax():
    assert dataclasses.asdict(ta.AlignerConfig()) \
        == dataclasses.asdict(ja.AlignerConfig())


def test_similarity_masked(aligners):
    jal, tal = aligners
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((3, 128, 400)).astype(np.float32)
    toks = rng.integers(0, 4096, (3, 16)).astype(np.int32)
    mel_valid = np.asarray([400, 250, 37], np.int32)
    tok_valid = np.asarray([16, 9, 1], np.int32)
    ref = ja._similarity(jal.params, jal.cfg, jnp.asarray(mel),
                         jnp.asarray(toks), jnp.asarray(mel_valid),
                         jnp.asarray(tok_valid))
    with torch.inference_mode():
        out = ta.similarity(tal.params, torch.from_numpy(mel),
                            torch.from_numpy(toks),
                            torch.from_numpy(mel_valid.astype(np.int64)),
                            torch.from_numpy(tok_valid.astype(np.int64)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (3, 16, 100)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n,t", [(1, 1), (1, 9), (3, 3), (5, 24),
                                 (17, 40), (24, 40), (2, 37)])
def test_viterbi_and_backtrack_match_host_dp(n, t):
    """Integer-valued log-probs (exact in f32): the device DP's spans are
    the host monotonic_align's, as in the JAX package's own test."""
    rng = np.random.default_rng(7 + n + t)
    n_pad, t_pad = 24, 40
    lp = rng.integers(-8, 0, (2, n_pad, t_pad)).astype(np.float32)
    lp[:, :, t:] = -1e30
    frames = torch.tensor([t, t])
    back = ta._viterbi(torch.from_numpy(lp), frames).numpy()
    starts, ends = ta._backtrack(back, frames.numpy(), np.array([n, n]),
                                 n_pad)
    for r in range(2):
        got = list(zip(starts[r, :n].tolist(), ends[r, :n].tolist()))
        assert got == ta.monotonic_align(lp[r, :n, :t].astype(np.float64))
        want = ja._dp_backtrack(jnp.asarray(lp[r]), jnp.int32(t),
                                jnp.int32(n))
        assert got == list(zip(np.asarray(want[0])[:n].tolist(),
                               np.asarray(want[1])[:n].tolist()))


def test_align_spans_identical(aligners):
    """The whole device path on a padded 4 s bucket: ragged rows, an
    empty row, int16 audio."""
    jal, tal = aligners
    lens = [4 * SR, 3 * SR + 555, SR // 2, 0]
    a16 = (np.clip(_batch(lens, 4), -1, 1) * 32767).astype(np.int16)
    rng = np.random.default_rng(1)
    toks = np.zeros((4, 32), np.int32)
    counts = [30, 12, 5, 0]
    for r, c in enumerate(counts):
        toks[r, :c] = rng.integers(0, 4096, c)
    js, je = ja.align_spans(jal.params, jal.cfg, jnp.asarray(a16),
                            jnp.asarray(toks),
                            jnp.asarray(np.asarray(lens, np.int32)),
                            jnp.asarray(np.asarray(counts, np.int32)))
    ts, te = ta.align_spans(tal.params, torch.from_numpy(a16),
                            torch.from_numpy(toks),
                            torch.tensor(lens), torch.tensor(counts))
    for r, c in enumerate(counts):
        assert ts[r, :c].tolist() == np.asarray(js)[r, :c].tolist()
        assert te[r, :c].tolist() == np.asarray(je)[r, :c].tolist()


def test_align_batch_audio_and_align_batch_identical(aligners):
    jal, tal = aligners
    lens = [2 * SR, SR + 321, 800, 0]
    audio = _batch(lens, 2)
    rows = [[5, 17, 99, 3, 2048, 7], [3, 2, 11], [9, 8, 7, 6, 5], []]
    got = tal.align_batch_audio(audio, rows, lens, n_pad=16)
    want = jal.align_batch_audio(audio, rows, lens, n_pad=16)
    assert got == want
    assert len(got[2]) == 5          # 2 conv frames < 5 tokens: spread
    a16 = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    af = a16.astype(np.float32) / 32767.0
    mels = np.asarray(jax_mel(jnp.asarray(af), n_mels=128))
    mel_valid = [-(-n // 160) for n in lens]
    got = tal.align_batch(mels, rows, mel_valid, n_pad=16)
    want = jal.align_batch(mels, rows, mel_valid, n_pad=16)
    assert got == want


def test_align_one_clip(aligners):
    jal, tal = aligners
    mel = np.random.default_rng(2).standard_normal(
        (128, 200)).astype(np.float32)
    assert tal.align(mel, [5, 17, 99, 3]) == jal.align(mel, [5, 17, 99, 3])
    assert tal.align(mel, []) == []


def test_merge_master_with_timestamps():
    spans = [ta.TokenSpan(1, 0.0, 0.5), ta.TokenSpan(2, 0.6, 1.0),
             ta.TokenSpan(3, 1.0, 1.2)]
    jspans = [ja.TokenSpan(*s) for s in spans]
    for master, texts in (("こんにちは、世界！", ["こんにちは", "世界", ""]),
                          ("あいう。えお", ["あい", "ん", "えお"]),
                          ("abc", ["a", "b", "c"])):
        assert ta.merge_master_with_timestamps(master, spans, texts) \
            == ja.merge_master_with_timestamps(master, jspans, texts)


def test_init_params_shapes():
    cfg = ta.AlignerConfig()
    p = ta.init_params(cfg, torch.Generator().manual_seed(0))
    ref = ja.init_params(ja.AlignerConfig(), jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    sd = {"".join(f"['{x}']" for x in k.split(".")): tuple(v.shape)
          for k, v in p.state_dict().items()}
    assert sd == flat
    assert float(p["temp"]) == 10.0
