"""The legacy ZipEnhancer-class U-Net denoiser in PyTorch (~2 M params).

Counterpart of ``whisperjav_tpu/models/enhancement/zipnet.py``: a
time-frequency masking U-Net over the power-compressed magnitude
spectrogram (conv2d encoder, stride 2 in frequency; dilated conv
bottleneck over time; decoder with skip connections; sigmoid mask),
reusing the noisy phase. :class:`ZipNet` holds the JAX package's flat
parameter names (``e1_w``, ``d3_b``, ...) as its state-dict names, so
its ``.npz`` files load unchanged.

The decoder's transposed convolutions are ``jax.lax.conv_transpose``
with ``padding="SAME"`` and no kernel flip, which is not torch's
``ConvTranspose2d``: here they are convolutions over the input dilated
by the stride, padded as JAX pads them (:func:`_same_transpose_pads`).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.utils.precision import full_f32
from whisperjav_tpu_torch.ops.stft import istft, stft

N_FFT = 400
HOP = 100
COMPRESS = 0.3
N_FREQS = N_FFT // 2 + 1   # 201


class ZipNet(nn.Module):
    """The U-Net's weights under the JAX package's flat names."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            setattr(self, name, nn.Parameter(torch.as_tensor(value),
                                             requires_grad=False))


def _conv2d(x, w, b, stride=(1, 1), dilation=(1, 1)):
    # x (B, C, F, T), w (O, I, kf, kt); symmetric padding
    pad = (((w.shape[2] - 1) * dilation[0]) // 2,
           ((w.shape[3] - 1) * dilation[1]) // 2)
    return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation)


def _same_transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``jax.lax.conv_transpose``'s (before, after) padding of the dilated
    input for ``padding="SAME"``: the output is input x stride."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


def _convT2d(x, w, b, stride=(2, 1)):
    """``jax.lax.conv_transpose(x, w, stride, "SAME")`` with OIHW ``w``
    used as it is (no flip, no in/out swap): zeros inserted between input
    rows by the stride, JAX's SAME padding, then a cross-correlation."""
    bsz, c, f, t = x.shape
    sf, st = stride
    xd = x.new_zeros((bsz, c, (f - 1) * sf + 1, (t - 1) * st + 1))
    xd[:, :, ::sf, ::st] = x
    pf = _same_transpose_pads(w.shape[2], sf)
    pt = _same_transpose_pads(w.shape[3], st)
    xd = F.pad(xd, (pt[0], pt[1], pf[0], pf[1]))
    return F.conv2d(xd, w, b)


def apply_mask_net(net: ZipNet, mag_c: torch.Tensor) -> torch.Tensor:
    """Compressed magnitude (B, F, T) -> sigmoid mask (B, F, T)."""
    p = net
    x = mag_c[:, None]                                   # (B, 1, F, T)
    e1 = F.elu(_conv2d(x, p.e1_w, p.e1_b))
    e2 = F.elu(_conv2d(e1, p.e2_w, p.e2_b, stride=(2, 1)))
    e3 = F.elu(_conv2d(e2, p.e3_w, p.e3_b, stride=(2, 1)))
    h = F.elu(_conv2d(e3, p.b1_w, p.b1_b, dilation=(1, 2)))
    h = F.elu(_conv2d(h, p.b2_w, p.b2_b, dilation=(1, 4)))
    h = F.elu(_conv2d(h, p.b3_w, p.b3_b, dilation=(1, 8))) + e3
    d3 = F.elu(_convT2d(h, p.d3_w, p.d3_b))
    d3 = d3[:, :, :e2.shape[2]] + e2
    d2 = F.elu(_convT2d(d3, p.d2_w, p.d2_b))
    d2 = d2[:, :, :e1.shape[2]] + e1
    mask = torch.sigmoid(_conv2d(d2, p.d1_w, p.d1_b))
    return mask[:, 0]


def denoise(net: ZipNet, audio: torch.Tensor, length: int) -> torch.Tensor:
    """audio (B, length) at 16 kHz -> denoised (B, length), f32."""
    with torch.inference_mode(), full_f32():
        real, imag = stft(audio.float(), N_FFT, HOP)
        mag = torch.sqrt(real * real + imag * imag + 1e-9)
        phase_r, phase_i = real / mag, imag / mag
        mag_c = torch.pow(mag, COMPRESS)
        mask = apply_mask_net(net, mag_c)
        mag_out = torch.pow(mag_c * mask, 1.0 / COMPRESS)
        return istft(mag_out * phase_r, mag_out * phase_i, length, N_FFT,
                     HOP)


def params_from_jax(tree: Mapping[str, object], device="cpu") -> ZipNet:
    """The JAX package's flat tree (array or numpy leaves) -> :class:`ZipNet`."""
    return ZipNet({k: torch.from_numpy(np.array(v, np.float32))
                   for k, v in tree.items()}).to(device)


def load_params(path: str, device="cpu") -> ZipNet:
    data = np.load(path)
    return params_from_jax({k: data[k] for k in data.files}, device)


def save_params(path: str, net: ZipNet) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in net.state_dict().items()})


def param_count(net: ZipNet) -> int:
    return sum(int(np.prod(v.shape)) for v in net.state_dict().values())
