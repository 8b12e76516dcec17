"""Port log-mel vs the JAX ``log_mel_spectrogram`` (f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperjav_tpu.ops import mel as jmel
from whisperjav_tpu_torch.ops import mel as tmel

# Both sides run the STFT as an f32 conv with sums in different orders;
# log10 of near-null bins magnifies that, so a few bins differ by ~4e-5
# (measured) while the mean stays ~1e-7.
ATOL = 2e-4
MEAN_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(jmel.N_SAMPLES) / jmel.SAMPLE_RATE
    speech = (0.3 * np.sin(2 * np.pi * 180 * t)
              * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
              + 0.05 * rng.standard_normal(t.size))
    speech[200_000:300_000] = 0.0          # a silent stretch
    noise = 0.1 * rng.standard_normal(t.size)
    return np.stack([speech, noise]).astype(np.float32)


def test_constants_match():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_SAMPLES",
                 "N_FRAMES"):
        assert getattr(tmel, name) == getattr(jmel, name)
    np.testing.assert_array_equal(tmel.mel_filterbank(128),
                                  jmel.mel_filterbank(128))
    np.testing.assert_array_equal(tmel._dft_conv_kernel(),
                                  jmel._dft_conv_kernel())


@pytest.mark.parametrize("n_mels", [80, 128])
def test_float_audio_matches_jax(n_mels):
    audio = _audio()
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio),
                                              n_mels=n_mels))
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio),
                                   n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (2, n_mels, jmel.N_FRAMES)
    err = np.abs(out - ref)
    assert err.max() < ATOL and err.mean() < MEAN_ATOL


def test_int16_audio_matches_jax():
    audio = (np.clip(_audio(1), -1, 1) * 32767).astype(np.int16)
    # the JAX engine reads int16 as samples / 32768 before the mel
    ref = np.asarray(jmel.log_mel_spectrogram(
        jnp.asarray(audio).astype(jnp.float32) * (1.0 / 32768.0),
        n_mels=128))
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio),
                                   n_mels=128).numpy()
    err = np.abs(out - ref)
    assert err.max() < ATOL and err.mean() < MEAN_ATOL
