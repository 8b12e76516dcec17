"""STFT and inverse STFT in PyTorch (for the enhancement models).

Counterpart of ``whisperjav_tpu/ops/stft.py`` with the same bases, so
the numbers match: the forward transform is a centred, reflect-padded
1-D convolution with the Hann-windowed (2F, 1, n_fft) DFT basis; the
inverse is a matmul with the windowed inverse basis, overlap-add on the
device (``F.fold``) and the WOLA normalisation (sum of squared windows
per sample). The bases and the normalisation are built once per shape
and device and kept there.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _fwd_kernel(n_fft: int, device: torch.device) -> torch.Tensor:
    """(2F, 1, n_fft) Hann-windowed DFT basis (cos rows, then sin)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_freqs)[:, None]
    angle = -2.0 * np.pi * n * k / n_fft
    window = np.hanning(n_fft + 1)[:-1][None, :]
    basis = np.concatenate([np.cos(angle) * window,
                            np.sin(angle) * window], axis=0)[:, None, :]
    return torch.from_numpy(basis.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def _inv_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    """(2F, n_fft) matrix mapping (real‖imag) spectra to windowed frames."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_freqs)[:, None]
    angle = 2.0 * np.pi * n * k / n_fft
    # irfft weights: conjugate-symmetric expansion, interior bins doubled
    scale = np.full((n_freqs, 1), 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    real_basis = np.cos(angle) * scale / n_fft
    imag_basis = -np.sin(angle) * scale / n_fft
    window = np.hanning(n_fft + 1)[:-1][None, :]
    basis = np.concatenate([real_basis * window, imag_basis * window],
                           axis=0)
    return torch.from_numpy(basis.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=16)
def _wola_norm(n_fft: int, hop: int, frames: int,
               device: torch.device) -> torch.Tensor:
    """(total,) sum of squared Hann windows over the frames covering each
    sample, floored at 1e-8 (float64 sums, as the JAX package's loop)."""
    total = (frames - 1) * hop + n_fft
    window = np.hanning(n_fft + 1)[:-1]
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).reshape(-1)
    norm = np.zeros(total, np.float64)
    np.add.at(norm, idx, np.tile(window ** 2, frames))
    return torch.from_numpy(np.maximum(norm, 1e-8).astype(np.float32)).to(
        device)


def stft(audio: torch.Tensor, n_fft: int = 400,
         hop: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (B, T) f32 -> (real, imag), each (B, F, frames); centred."""
    pad = n_fft // 2
    x = F.pad(audio[:, None, :].float(), (pad, pad), mode="reflect")
    out = F.conv1d(x, _fwd_kernel(n_fft, x.device), stride=hop)
    n_freqs = n_fft // 2 + 1
    return out[:, :n_freqs], out[:, n_freqs:]


def istft(real: torch.Tensor, imag: torch.Tensor, length: int,
          n_fft: int = 400, hop: int = 100) -> torch.Tensor:
    """Inverse of :func:`stft` (WOLA with Hann analysis and synthesis)
    -> (B, length)."""
    frames = real.shape[-1]
    spec = torch.cat([real, imag], dim=1).float()           # (B, 2F, T)
    frames_time = torch.einsum("bft,fn->bnt", spec,
                               _inv_basis(n_fft, spec.device))  # (B, n, T)
    total = (frames - 1) * hop + n_fft
    out = F.fold(frames_time, output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop))[:, 0, 0]                  # overlap-add
    norm = _wola_norm(n_fft, hop, frames, spec.device)
    pad = n_fft // 2
    return (out / norm[None, :])[:, pad:pad + length]
