"""Silero-class frame VAD model in PyTorch.

Counterpart of ``whisperjav_tpu/models/vad/silero_like.py``: a fresh
architecture in the class of the torch-JIT Silero models the reference
loads via torch.hub (reference: whisperjav/modules/
speech_segmentation/backends/silero.py:53-96), ~200 k params: 40-band
log-mel features → two stride-2 convs → GRU over frames → per-frame
speech probability at 40 ms resolution.

The GRU is ``nn.GRU`` over every frame (:func:`_flat.run_rnn`). The JAX tree's gates
are (r, z, n) with the bias on the input side only, which is
``nn.GRU`` with ``bias_hh`` zero: ``weight_ih = gru_wx.T``,
``weight_hh = gru_wh.T``, ``bias_ih = gru_b``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.vad._flat import (
    as_numpy, frozen, load_npz, rnn_with, run_rnn, save_npz,
)
from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
from whisperjav_tpu_torch.utils.precision import full_f32

FRAME_S = 0.04          # output frame resolution (2× mel hop of 10 ms ×2)
N_MELS = 40


class SileroLike(nn.Module):
    """The silero-class network, built from a JAX-layout tree."""

    def __init__(self, tree: Mapping[str, Any], device="cpu"):
        super().__init__()
        for name in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "out_w",
                     "out_b"):
            setattr(self, name, frozen(tree[name], device))
        wx = as_numpy(tree["gru_wx"])
        hidden = wx.shape[1] // 3
        self.gru = rnn_with(nn.GRU, wx.shape[0], hidden, {
            "weight_ih_l0": wx.T, "weight_hh_l0": as_numpy(tree["gru_wh"]).T,
            "bias_ih_l0": tree["gru_b"],
            "bias_hh_l0": np.zeros(3 * hidden, np.float32)}, device)

    def tree(self) -> Dict[str, np.ndarray]:
        """The JAX package's parameter tree (numpy leaves)."""
        out = {name: as_numpy(p) for name, p in self.named_parameters()
               if not name.startswith("gru.")}
        out["gru_wx"] = as_numpy(self.gru.weight_ih_l0).T
        out["gru_wh"] = as_numpy(self.gru.weight_hh_l0).T
        out["gru_b"] = as_numpy(self.gru.bias_ih_l0)
        return out


@torch.inference_mode()
def probs(model: SileroLike, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T samples @16 kHz, T multiple of 640) → probs (B, T/640),
    in full f32."""
    with full_f32():
        mel = log_mel_spectrogram(audio.float(), n_mels=N_MELS)  # (B, 40, T/160)
        x = F.relu(F.conv1d(mel, model.conv1_w, model.conv1_b, stride=2,
                            padding=1))
        x = F.relu(F.conv1d(x, model.conv2_w, model.conv2_b, stride=2,
                            padding=1))
        hs = run_rnn(model.gru, x.transpose(1, 2))     # (B, F, H)
        logits = torch.matmul(hs, model.out_w) + model.out_b
        return torch.sigmoid(logits[..., 0])


def init_params(generator: torch.Generator, hidden: int = 128,
                device="cpu") -> SileroLike:
    """Random weights with the JAX package's init distribution, drawn
    from ``generator`` (which must live on ``device``)."""
    def w(shape, scale=None):
        scale = scale or shape[-2] ** -0.5
        return torch.randn(shape, generator=generator, device=device) * scale

    zeros = lambda n: torch.zeros(n, device=device)   # noqa: E731
    return SileroLike({
        "conv1_w": w((64, N_MELS, 3), 0.1), "conv1_b": zeros(64),
        "conv2_w": w((hidden, 64, 3), 0.1), "conv2_b": zeros(hidden),
        "gru_wx": w((hidden, 3 * hidden)), "gru_wh": w((hidden, 3 * hidden)),
        "gru_b": zeros(3 * hidden),
        "out_w": w((hidden, 1)), "out_b": zeros(1),
    }, device)


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> SileroLike:
    """The JAX package's parameter tree → :class:`SileroLike`."""
    return SileroLike(tree, device)


def load_params(path: str, device="cpu") -> SileroLike:
    """The JAX package's ``.npz`` → :class:`SileroLike` on ``device``."""
    return SileroLike(load_npz(path), device)


def save_params(path: str, model: SileroLike) -> None:
    """Write the JAX package's ``.npz`` layout (one array per leaf)."""
    save_npz(path, model.tree())
