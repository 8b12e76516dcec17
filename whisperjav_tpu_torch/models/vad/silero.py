"""Silero VAD (v5/v6 pip-package generation) in PyTorch.

Counterpart of ``whisperjav_tpu/models/vad/silero.py`` and of the
torch-JIT model the reference loads (reference: whisperjav/modules/
speech_segmentation/backends/silero.py:199 via torch.hub,
backends/silero_v6.py via the silero-vad package). The published 16 kHz
graph is:

    512-sample chunks (+64 context samples carried from the previous
    chunk) → STFT as a fixed conv basis (forward_basis_buffer,
    (258, 1, 256), stride 128, the 576-sample input reflect-padded by 64
    on the right) → magnitude (129 bins, 4 frames/chunk) → 4×[Conv1d k3
    p1 + ReLU] encoder (129→128 s1, 128→64 s2, 64→64 s2, 64→128 s1) →
    LSTM(128) carried across chunks → ReLU → Conv1d(128→1, k1) → sigmoid
    = one speech prob per 32 ms.

The STFT and the encoder run over every chunk of the clip at once; the
LSTM is ``nn.LSTM`` over all chunks (cuDNN on the card; pieces of 16,384
steps, seven calls for an hour), not a loop of per-chunk steps. :func:`probs` runs in full f32 (no TF32), so
the card and the CPU agree to ~1e-5.

Parameters keep the JAX tree's leaf names (``stft_basis``, ``enc{i}_w``,
``head_w``, ...), the LSTM's as ``lstm.weight_ih_l0`` etc.; :func:`tree`
gives the JAX layout back, and :func:`save_params` / :func:`load_params`
read and write the JAX package's ``.npz``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.vad._flat import (
    LSTM_LEAVES, as_numpy, frozen, load_npz, lstm_from_tree, run_rnn,
    save_npz,
)
from whisperjav_tpu_torch.utils.precision import full_f32

CHUNK = 512             # samples per probability frame @16 kHz
CONTEXT = 64            # samples carried from the previous chunk
FRAME_S = CHUNK / 16000.0   # 32 ms
_N_FFT = 256
_HOP = 128
_N_BINS = 129
HIDDEN = 128
# (leaf, stride) of the conv encoder
_ENCODER = (("enc0", 1), ("enc1", 2), ("enc2", 2), ("enc3", 1))


def _stft_basis() -> np.ndarray:
    """Fourier forward basis as a (258, 1, 256) conv kernel (hann-windowed),
    matching the layout of the JIT export's forward_basis_buffer."""
    n = _N_FFT
    k = np.arange(n)
    freqs = np.arange(_N_BINS)
    ang = 2.0 * np.pi * freqs[:, None] * k[None, :] / n
    window = np.hanning(n + 1)[:n]
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * window
    return basis[:, None, :].astype(np.float32)


class SileroVAD(nn.Module):
    """The v5/v6 network, built from a JAX-layout tree (numpy or tensors)."""

    def __init__(self, tree: Mapping[str, Any], device="cpu"):
        super().__init__()
        self.stft_basis = frozen(tree["stft_basis"], device)
        for name, _ in _ENCODER:
            setattr(self, f"{name}_w", frozen(tree[f"{name}_w"], device))
            setattr(self, f"{name}_b", frozen(tree[f"{name}_b"], device))
        self.lstm = lstm_from_tree(tree, HIDDEN, device)
        self.head_w = frozen(tree["head_w"], device)
        self.head_b = frozen(tree["head_b"], device)

    def tree(self) -> Dict[str, np.ndarray]:
        """The JAX package's parameter tree (numpy leaves)."""
        out = {name: as_numpy(p) for name, p in self.named_parameters()
               if not name.startswith("lstm.")}
        for name, leaf in LSTM_LEAVES.items():
            out[leaf] = as_numpy(getattr(self.lstm, name))
        return out


def _frames_from_audio(audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) with T a multiple of CHUNK → (B, F, CHUNK+CONTEXT)."""
    b, t = audio.shape
    main = audio.reshape(b, t // CHUNK, CHUNK)
    ctx = torch.cat([audio.new_zeros((b, 1, CONTEXT)),
                     main[:, :-1, -CONTEXT:]], dim=1)
    return torch.cat([ctx, main], dim=-1)


def chunk_features(model: SileroVAD, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) → per-chunk encoder features (B, F, HIDDEN): the STFT
    and the conv encoder over every chunk at once."""
    b = audio.shape[0]
    frames = _frames_from_audio(audio)              # (B, F, 576)
    f = frames.shape[1]
    x = frames.reshape(b * f, 1, CHUNK + CONTEXT)
    x = F.pad(x, (0, CONTEXT), mode="reflect")      # right reflect-pad
    spec = F.conv1d(x, model.stft_basis, stride=_HOP)   # (BF, 258, 4)
    h = torch.sqrt(spec[:, :_N_BINS] ** 2 + spec[:, _N_BINS:] ** 2 + 1e-12)
    for name, stride in _ENCODER:
        h = F.relu(F.conv1d(h, getattr(model, f"{name}_w"),
                            getattr(model, f"{name}_b"), stride=stride,
                            padding=1))
    return h[:, :, 0].reshape(b, f, HIDDEN)


@torch.inference_mode()
def probs(model: SileroVAD, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T samples @16 kHz, T multiple of 512) → probs (B, T/512),
    one per 32 ms chunk (v5/v6 semantics; state reset at clip start)."""
    with full_f32():
        feats = chunk_features(model, audio.float())    # (B, F, H)
        hs = run_rnn(model.lstm, feats)                 # all F at once
        logits = torch.matmul(F.relu(hs), model.head_w[:, :, 0].t())
        return torch.sigmoid(logits[..., 0] + model.head_b)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, device="cpu") -> SileroVAD:
    """Random weights with the JAX package's init distribution (N(0, 0.1²)
    matrices, zero biases, the fixed STFT basis), drawn from
    ``generator``, which must live on ``device``."""
    def w(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.1

    zeros = lambda n: torch.zeros(n, device=device)   # noqa: E731
    return SileroVAD({
        "stft_basis": _stft_basis(),
        "enc0_w": w(128, _N_BINS, 3), "enc0_b": zeros(128),
        "enc1_w": w(64, 128, 3), "enc1_b": zeros(64),
        "enc2_w": w(64, 64, 3), "enc2_b": zeros(64),
        "enc3_w": w(128, 64, 3), "enc3_b": zeros(128),
        "lstm_wi": w(4 * HIDDEN, HIDDEN), "lstm_wh": w(4 * HIDDEN, HIDDEN),
        "lstm_bi": zeros(4 * HIDDEN), "lstm_bh": zeros(4 * HIDDEN),
        "head_w": w(1, HIDDEN, 1), "head_b": zeros(1),
    }, device)


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> SileroVAD:
    """The JAX package's parameter tree → :class:`SileroVAD` on ``device``."""
    return SileroVAD(tree, device)


def params_from_torch_state_dict(sd: Mapping[str, Any],
                                 dtype=np.float32) -> Dict[str, np.ndarray]:
    """Map a silero-vad JIT export's state dict onto the JAX tree layout.

    Accepts the ``_model.``-prefixed names of the published 16 kHz JIT
    model (v5/v6) and the same names unprefixed.
    """
    def get(*names):
        for name in names:
            for prefix in ("_model.", ""):
                key = prefix + name
                if key in sd:
                    return as_numpy(sd[key]).astype(dtype)
        raise KeyError(f"none of {names} (with/without '_model.') in "
                       "state dict")

    out = {"stft_basis": get("stft.forward_basis_buffer")}
    if out["stft_basis"].ndim == 2:
        out["stft_basis"] = out["stft_basis"][:, None, :]
    for i in range(4):
        out[f"enc{i}_w"] = get(f"encoder.{i}.reparam_conv.weight",
                               f"encoder.{i}.weight")
        out[f"enc{i}_b"] = get(f"encoder.{i}.reparam_conv.bias",
                               f"encoder.{i}.bias")
    out["lstm_wi"] = get("decoder.rnn.weight_ih")
    out["lstm_wh"] = get("decoder.rnn.weight_hh")
    out["lstm_bi"] = get("decoder.rnn.bias_ih")
    out["lstm_bh"] = get("decoder.rnn.bias_hh")
    head_w = get("decoder.decoder.2.weight", "decoder.decoder.1.weight")
    out["head_w"] = head_w if head_w.ndim == 3 else head_w[:, :, None]
    out["head_b"] = get("decoder.decoder.2.bias", "decoder.decoder.1.bias")
    return out


def load_params(path: str, device="cpu") -> SileroVAD:
    """The JAX package's ``.npz`` → :class:`SileroVAD` on ``device``."""
    return SileroVAD(load_npz(path), device)


def save_params(path: str, model: SileroVAD) -> None:
    """Write the JAX package's ``.npz`` layout (one array per leaf)."""
    save_npz(path, model.tree())
