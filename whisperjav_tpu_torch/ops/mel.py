"""Whisper log-mel spectrogram in PyTorch.

Counterpart of ``whisperjav_tpu/ops/mel.py``, whose constants and numpy
helpers are copied here because that module imports jax. Same
semantics as openai-whisper's ``log_mel_spectrogram``: n_fft=400,
hop=160, periodic Hann window, centred reflect padding, the last STFT
frame dropped, Slaney mel filterbank, log10 clamped at 1e-10, then
``max - 8`` and ``(x + 4) / 4``. The STFT is one strided conv1d with a
windowed DFT basis, as in the JAX version; it and the filterbank's
matmul run in full f32 (no TF32, whatever the process-wide flags say).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from whisperjav_tpu_torch.utils.precision import full_f32

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE      # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH          # 3000 mel frames per window


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    lin = 3.0 * freq / 200.0
    logstep = 27.0 / np.log(6.4)
    log_part = 15.0 + np.log(np.maximum(freq, 1e-12) / min_log_hz) * logstep
    return np.where(freq >= min_log_hz, log_part, lin)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    lin = 200.0 * mels / 3.0
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    lin)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_freqs: int = N_FFT // 2 + 1,
                   sample_rate: int = SAMPLE_RATE,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style triangular mel filterbank with Slaney area normalization.

    Shape (n_mels, n_freqs); float32.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_conv_kernel(n_fft: int = N_FFT) -> np.ndarray:
    """Windowed DFT basis as a conv kernel (2*n_freqs, 1, n_fft): output
    channels 0..n_freqs-1 are the real parts, the rest the imaginary."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_freqs)[:, None]
    angle = -2.0 * np.pi * n * k / n_fft
    window = np.hanning(n_fft + 1)[:-1][None, :]  # periodic Hann
    real = np.cos(angle) * window
    imag = np.sin(angle) * window
    kernel = np.concatenate([real, imag], axis=0)[:, None, :]
    return kernel.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        n_fft: int = N_FFT,
                        hop: int = HOP_LENGTH) -> torch.Tensor:
    """Whisper log-mel features of ``(..., n_samples)`` audio.

    int16 audio is read as samples / 32768. n_samples must be a multiple
    of ``hop``. Returns ``(..., n_mels, n_samples // hop)`` float32.
    """
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    audio = audio.float()
    n_samples = audio.shape[-1]
    n_frames = n_samples // hop
    batch_shape = audio.shape[:-1]
    flat = audio.reshape(-1, 1, n_samples)
    padded = F.pad(flat, (n_fft // 2, n_fft // 2), mode="reflect")
    kernel = torch.from_numpy(_dft_conv_kernel(n_fft)).to(audio.device)
    n_freqs = n_fft // 2 + 1
    fbank = torch.from_numpy(mel_filterbank(n_mels, n_freqs)).to(audio.device)
    with full_f32():
        stft = F.conv1d(padded, kernel, stride=hop)[..., :n_frames]
        real, imag = stft[:, :n_freqs], stft[:, n_freqs:]
        power = real * real + imag * imag                  # (B, F, T)
        mel = torch.matmul(fbank, power)                   # (B, n_mels, T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.reshape(*batch_shape, *log_spec.shape[1:])
