"""TEN-class lightweight frame VAD in PyTorch.

Counterpart of ``whisperjav_tpu/models/vad/ten.py``, the distinct small
frame-DNN family of the reference's TEN VAD backend (reference:
whisperjav/modules/speech_segmentation/backends/ten.py:76-97 binds the
ten-vad C library: int16 @16 kHz, hop 256 = 16 ms frames, ~300 KB
model):

    per-hop features: 40-band Slaney log-mel over a 512-sample centered
    hann window (the rFFT as one matmul) + a pitch-salience feature (the
    largest normalized autocorrelation over lags 32..248 step 8) → ±1
    frame context stacking (123-d) → 2×[Conv1d k3 + ReLU] → LSTM(64)
    over frames → sigmoid per 16 ms hop.

The features run over every frame at once; the LSTM is ``nn.LSTM``
over every frame (:func:`_flat.run_rnn`). :func:`params_from_onnx` binds a vendor ONNX file's weights
through the port's ``utils/onnx_io``.
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
from whisperjav_tpu_torch.ops.mel import mel_filterbank
from whisperjav_tpu_torch.utils.precision import full_f32

HOP = 256                    # samples per frame @16 kHz → 16 ms
WIN = 512                    # analysis window (2 hops, centered)
N_MELS = 40
FRAME_S = HOP / 16000.0
_CONTEXT = 1                 # ±1 frame stacking
_FEAT = N_MELS + 1           # mel + pitch salience
_IN = _FEAT * (2 * _CONTEXT + 1)
HIDDEN = 64
_LAG_MIN, _LAG_MAX = 32, 256  # 62–500 Hz F0 search band


class TenVAD(nn.Module):
    """The TEN-class network, built from a JAX-layout tree."""

    def __init__(self, tree: Mapping[str, Any], device="cpu"):
        super().__init__()
        for name in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "out_w",
                     "out_b"):
            setattr(self, name, frozen(tree[name], device))
        self.lstm = lstm_from_tree(tree, HIDDEN, device)

    def tree(self) -> Dict[str, np.ndarray]:
        """The JAX package's parameter tree (numpy leaves)."""
        out = {name: as_numpy(p) for name, p in self.named_parameters()
               if not name.startswith("lstm.")}
        for name, leaf in LSTM_LEAVES.items():
            out[leaf] = as_numpy(getattr(self.lstm, name))
        return out


def _rfft_basis() -> np.ndarray:
    """(2 * 257, WIN): the real rows cos, the imaginary rows sin of the
    forward DFT angle."""
    k = np.arange(WIN // 2 + 1)[:, None] * np.arange(WIN)[None, :]
    ang = -2.0 * np.pi * k / WIN
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=0).astype(
        np.float32)


def frame_features(audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) with T % HOP == 0 → features (B, F, 41): log-mel and
    pitch salience of each hop's centered window (zero-padded edges)."""
    dev = audio.device
    pad = (WIN - HOP) // 2
    x = F.pad(audio, (pad, pad))
    frames = x.unfold(-1, WIN, HOP)                    # (B, F, WIN)
    window = torch.from_numpy(np.hanning(WIN + 1)[:WIN].astype(np.float32))
    fw = frames * window.to(dev)
    spec = torch.matmul(fw, torch.from_numpy(_rfft_basis()).to(dev).t())
    n_bins = WIN // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mels = torch.from_numpy(mel_filterbank(N_MELS, n_bins)).to(dev)
    logmel = torch.log10(torch.matmul(power, mels.t()) + 1e-10)

    # pitch salience: max normalized autocorrelation in the F0 lag band
    span = WIN - _LAG_MAX
    a = fw[..., :span]
    energy_a = (a * a).sum(-1)
    pitch = None
    for lag in range(_LAG_MIN, _LAG_MAX, 8):
        b = fw[..., lag:lag + span]
        corr = (a * b).sum(-1) / (torch.sqrt(energy_a * (b * b).sum(-1))
                                  + 1e-6)
        pitch = corr if pitch is None else torch.maximum(pitch, corr)
    return torch.cat([logmel, pitch[..., None]], dim=-1)


@torch.inference_mode()
def probs(model: TenVAD, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T @16 kHz, T % 256 == 0) → speech probs (B, T/256), in
    full f32."""
    with full_f32():
        feats = frame_features(audio.float())          # (B, F, 41)
        f = feats.shape[1]
        padded = F.pad(feats, (0, 0, _CONTEXT, _CONTEXT))
        stacked = torch.cat([padded[:, i:i + f]
                             for i in range(2 * _CONTEXT + 1)], dim=-1)
        x = F.relu(F.conv1d(stacked.transpose(1, 2), model.conv1_w,
                            model.conv1_b, padding=1))
        x = F.relu(F.conv1d(x, model.conv2_w, model.conv2_b, padding=1))
        hs = run_rnn(model.lstm, x.transpose(1, 2))    # (B, F, H)
        logits = torch.matmul(hs, model.out_w.t())
        return torch.sigmoid(logits[..., 0] + model.out_b)


def init_params(generator: torch.Generator, device="cpu") -> TenVAD:
    """Random weights with the JAX package's init distribution, drawn
    from ``generator`` (which must live on ``device``)."""
    def w(shape, scale=None):
        scale = scale or (shape[1] * (shape[2] if len(shape) > 2 else 1)
                          ) ** -0.5
        return torch.randn(shape, generator=generator, device=device) * scale

    zeros = lambda n: torch.zeros(n, device=device)   # noqa: E731
    return TenVAD({
        "conv1_w": w((HIDDEN, _IN, 3)), "conv1_b": zeros(HIDDEN),
        "conv2_w": w((HIDDEN, HIDDEN, 3)), "conv2_b": zeros(HIDDEN),
        "lstm_wi": w((4 * HIDDEN, HIDDEN), HIDDEN ** -0.5),
        "lstm_wh": w((4 * HIDDEN, HIDDEN), HIDDEN ** -0.5),
        "lstm_bi": zeros(4 * HIDDEN), "lstm_bh": zeros(4 * HIDDEN),
        "out_w": w((1, HIDDEN), HIDDEN ** -0.5), "out_b": zeros(1),
    }, device)


def params_from_jax(tree: Mapping[str, Any], device="cpu") -> TenVAD:
    """The JAX package's parameter tree → :class:`TenVAD`."""
    return TenVAD(tree, device)


def load_params(path: str, device="cpu") -> TenVAD:
    """The JAX package's ``.npz`` → :class:`TenVAD` on ``device``."""
    return TenVAD(load_npz(path), device)


def save_params(path: str, model: TenVAD) -> None:
    """Write the JAX package's ``.npz`` layout (one array per leaf)."""
    save_npz(path, model.tree())


# ---------------------------------------------------------------------------
# vendor ONNX binding (the reference backend consumes the ten-vad model
# file through onnxruntime; its tensors bind directly into the tree)
# ---------------------------------------------------------------------------

def params_from_onnx(src) -> Dict[str, np.ndarray]:
    """Bind an ONNX VAD model file's weights into the JAX tree layout
    (numpy leaves; :func:`params_from_jax` makes the module).

    Two vendor layouts are handled:

    * **torch-export naming** — ``torch.onnx.export`` keeps state-dict
      names as initializer names: ``conv1.weight``, ``conv2.weight``,
      ``lstm.weight_ih_l0`` / ``weight_hh_l0`` / ``bias_*_l0`` (ifgo
      gate rows, exactly the tree's layout) and ``out.weight`` /
      ``out.bias``.
    * **native ONNX ops** — a graph using the ONNX ``LSTM`` operator
      stores W (1, 4H, I), R (1, 4H, H), B (1, 8H) with the spec's
      ``iofc`` gate order; ``Conv`` and ``Gemm``/``MatMul`` nodes carry
      their weights as initializer inputs. Binding is structural
      (topology + shape), so it is naming-independent.

    Raises ``ValueError`` when the graph's shapes don't match this
    architecture (hop-256 frame VAD with a single 64-wide LSTM).
    """
    from whisperjav_tpu_torch.utils.onnx_io import (
        lstm_reorder_gates, read_onnx, topo_order,
    )

    model = read_onnx(src)
    init = model.graph.initializers

    def a(x):
        return np.asarray(x, np.float32)

    if "lstm.weight_ih_l0" in init:                     # torch export
        return {
            "conv1_w": a(init["conv1.weight"]),
            "conv1_b": a(init["conv1.bias"]),
            "conv2_w": a(init["conv2.weight"]),
            "conv2_b": a(init["conv2.bias"]),
            "lstm_wi": a(init["lstm.weight_ih_l0"]),
            "lstm_wh": a(init["lstm.weight_hh_l0"]),
            "lstm_bi": a(init["lstm.bias_ih_l0"]),
            "lstm_bh": a(init["lstm.bias_hh_l0"]),
            "out_w": a(init["out.weight"]),
            "out_b": a(init["out.bias"]),
        }

    # structural: find the LSTM op, the Convs before it, the Gemm after
    nodes = topo_order(model.graph)
    lstms = [n for n in nodes if n.op_type == "LSTM"]
    if not lstms:
        raise ValueError(
            "ONNX graph has neither torch-export names nor an LSTM op; "
            f"initializers: {sorted(init)[:8]}")
    lstm = lstms[0]
    w = a(init[lstm.inputs[1]])                         # (1, 4H, I)
    r = a(init[lstm.inputs[2]])                         # (1, 4H, H)
    hidden = r.shape[-1]
    if w.ndim == 3:
        w, r = w[0], r[0]
    bi = bh = np.zeros((4 * hidden,), np.float32)
    if len(lstm.inputs) > 3 and lstm.inputs[3] in init:
        b = a(init[lstm.inputs[3]]).reshape(-1)
        bi, bh = b[:4 * hidden], b[4 * hidden:8 * hidden]

    convs = []
    for n in nodes:
        if n.op_type == "LSTM":
            break
        if n.op_type == "Conv":
            cw = a(init[n.inputs[1]])
            cb = (a(init[n.inputs[2]])
                  if len(n.inputs) > 2 and n.inputs[2] in init
                  else np.zeros((cw.shape[0],), np.float32))
            convs.append((cw, cb))
    if len(convs) != 2:
        raise ValueError(
            f"expected 2 Conv nodes before the LSTM, found {len(convs)}")

    ow, ob = None, np.zeros((1,), np.float32)
    for n in nodes[nodes.index(lstm) + 1:]:
        if n.op_type in ("Gemm", "MatMul"):
            ow = a(init[n.inputs[1]])
            if n.op_type == "Gemm":
                if not n.attrs.get("transB", 0):
                    ow = ow.T                           # -> (out, in)
                if len(n.inputs) > 2 and n.inputs[2] in init:
                    ob = a(init[n.inputs[2]]).reshape(-1)
            elif ow.shape[0] == hidden:                 # (in, out)
                ow = ow.T
        elif n.op_type == "Add" and ow is not None:
            for src_name in n.inputs:
                if src_name in init:
                    ob = a(init[src_name]).reshape(-1)
    if ow is None:
        raise ValueError("no Gemm/MatMul output head after the LSTM")

    return {
        "conv1_w": convs[0][0], "conv1_b": convs[0][1],
        "conv2_w": convs[1][0], "conv2_b": convs[1][1],
        "lstm_wi": lstm_reorder_gates(w, hidden),
        "lstm_wh": lstm_reorder_gates(r, hidden),
        "lstm_bi": lstm_reorder_gates(bi, hidden),
        "lstm_bh": lstm_reorder_gates(bh, hidden),
        "out_w": ow, "out_b": ob,
    }
