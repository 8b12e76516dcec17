"""The port's STFT and inverse STFT (and the ZipEnhancer's magnitude/phase
wrappers) against the JAX package's on the same numpy-seeded audio, f32
on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperjav_tpu.models.enhancement import zipenhancer as jzz
from whisperjav_tpu.ops import stft as jstft
from whisperjav_tpu_torch.models.enhancement import zipenhancer as tzz
from whisperjav_tpu_torch.ops import stft as tstft


def _audio(batch, n, seed):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,n", [(400, 100, 4000), (400, 100, 4321),
                                         (256, 64, 3001), (255, 50, 2000)])
def test_stft_and_istft_match_jax(n_fft, hop, n):
    """Real and imaginary parts within 2e-5 (f32 convolutions summed in
    another order); the inverse within 1e-6 of JAX's and of the input."""
    audio = _audio(2, n, n)
    r_j, i_j = jstft.stft(jnp.asarray(audio), n_fft, hop)
    r_t, i_t = tstft.stft(torch.from_numpy(audio), n_fft, hop)
    assert r_t.shape == r_j.shape and i_t.shape == i_j.shape
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=2e-5)
    np.testing.assert_allclose(i_t.numpy(), np.asarray(i_j), atol=2e-5)
    y_j = np.asarray(jstft.istft(r_j, i_j, n, n_fft, hop))
    y_t = tstft.istft(r_t, i_t, n, n_fft, hop).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)
    np.testing.assert_allclose(y_t, audio, atol=1e-5)


def test_wola_norm_is_the_jax_loop():
    """The cached, vectorised WOLA normalisation equals the JAX package's
    per-call Python loop exactly."""
    for n_fft, hop, frames in ((400, 100, 41), (256, 64, 7), (255, 50, 3)):
        window = np.hanning(n_fft + 1)[:-1]
        total = (frames - 1) * hop + n_fft
        ref = np.zeros(total, np.float64)
        for f in range(frames):
            ref[f * hop: f * hop + n_fft] += window ** 2
        ref = np.maximum(ref, 1e-8).astype(np.float32)
        np.testing.assert_array_equal(
            tstft._wola_norm(n_fft, hop, frames, torch.device("cpu")).numpy(),
            ref)


def test_mag_pha_stft_and_istft_match_jax():
    """Compressed magnitudes within 2e-4 abs / 1e-3 rel; phases on the unit
    circle within 2e-3 where the bin holds energy; the round trip within
    1e-3 x max |x| of the JAX one."""
    audio = _audio(1, 8000, 1)
    mag_j, pha_j = jzz.mag_pha_stft(jnp.asarray(audio))
    mag_t, pha_t = tzz.mag_pha_stft(torch.from_numpy(audio))
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=2e-4,
                               rtol=1e-3)
    big = np.asarray(mag_j) > 1e-2
    for fn in (np.cos, np.sin):
        np.testing.assert_allclose(fn(pha_t.numpy())[big],
                                   fn(np.asarray(pha_j))[big], atol=2e-3)
    w_j = np.asarray(jzz.mag_pha_istft(mag_j, pha_j, 8000))
    w_t = tzz.mag_pha_istft(mag_t, pha_t, 8000).numpy()
    tol = 1e-3 * np.abs(audio).max()
    np.testing.assert_allclose(w_t, w_j, atol=tol)
    np.testing.assert_allclose(w_t, audio, atol=tol)
