"""Checkpoint-faithful MossFormer2_SE_48K speech enhancement in PyTorch.

Counterpart of ``whisperjav_tpu/models/enhancement/mossformer2.py``: the
ClearerVoice-Studio MossFormer2 SE mask net, ClearVoice's default
("best quality") model. A 180-dim kaldi-style log-mel fbank (hamming,
n_fft 1920, hop 384 at 48 kHz) -> GroupNorm(1) -> 1x1 conv to 512 ->
scaled sinusoid positions -> ``num_blocks`` MossFormer2 layers (gated
FLASH attention: token shift, OffsetScale roles, ``relu(qk/g)^2``
attention inside groups of 256 frames plus global linear attention;
then a gated FSMN block with a depthwise memory over TIME) -> LayerNorm,
GroupNorm(1), intra skip -> PReLU -> 1x1 conv -> tanh x sigmoid gate ->
1x1 conv to 961 bins -> ReLU: a magnitude mask on the noisy hamming
STFT (noisy phase kept), then the WOLA inverse.

:class:`MossFormer2` holds its tensors under the vendor's module names
(``mdl.intra_mdl.mossformerM.layers.{i}.to_hidden.mdl.1.weight``,
``...fsmn.{i}.gated_fsmn.fsmn.conv1.weight``, ``conv1_decoder.weight``,
...), so a published MaskNet state dict loads with ``load_state_dict``;
the JAX package's ``lax.scan`` over blocks is a ``ModuleList``.
:func:`params_from_jax` and :func:`save_params` read and write the JAX
package's tree and ``.npz`` layout. The forward pass is f32 with no
TF32, as the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.enhancement._treemap import (
    Entry, load_module, state_dict_from_tree, tree_from_state_dict,
)
from whisperjav_tpu_torch.utils.precision import full_f32

SAMPLE_RATE = 48_000
N_FFT = 1920
HOP = 384


@dataclass(frozen=True)
class MossFormer2Config:
    n_mels: int = 180                 # masknet in_channels
    d_model: int = 512                # masknet out_channels
    n_freqs: int = 961                # masknet out_channels_final
    num_blocks: int = 24
    group_size: int = 256
    qk_dim: int = 128
    rope_dim: int = 32                # min(32, qk_dim)
    expansion: int = 4                # FLASH hidden = dim * expansion
    fsmn_inner: int = 256             # Gated_FSMN_Block inner channels
    lorder: int = 20                  # UniDeepFsmn memory half-order
    n_fft: int = N_FFT
    hop: int = HOP
    sample_rate: int = SAMPLE_RATE

    @property
    def hidden(self) -> int:          # v/u stream width (dim * exp / 2)
        return self.d_model * self.expansion // 2


MOSSFORMER2_SE_48K = MossFormer2Config()

# tiny geometry for tests (dims even, rope_dim < qk_dim, 2 blocks)
MF2_TEST = MossFormer2Config(
    n_mels=6, d_model=16, n_freqs=9, num_blocks=2, group_size=8,
    qk_dim=8, rope_dim=4, expansion=4, fsmn_inner=12, lorder=3,
    n_fft=16, hop=4, sample_rate=16_000)


# ---------------------------------------------------------------------------
# frontend: hamming STFT + kaldi-style fbank (frames aligned 1:1)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _hamming_dft_kernel(n_fft: int, device: torch.device) -> torch.Tensor:
    """(2F, 1, n_fft) conv kernel computing a hamming-windowed rDFT."""
    n_freqs = n_fft // 2 + 1
    angle = 2.0 * np.pi * np.outer(np.arange(n_freqs), np.arange(n_fft)) \
        / n_fft
    win = np.hamming(n_fft)[None, :]
    basis = np.concatenate([np.cos(angle) * win, -np.sin(angle) * win],
                           axis=0)[:, None, :]
    return torch.from_numpy(basis.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=4)
def _hamming_inv_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    """(2F, n_fft): (real || imag) spectra -> hamming-windowed frames."""
    n_freqs = n_fft // 2 + 1
    angle = 2.0 * np.pi * np.outer(np.arange(n_freqs), np.arange(n_fft)) \
        / n_fft
    scale = np.full((n_freqs, 1), 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    win = np.hamming(n_fft)[None, :]
    basis = np.concatenate([np.cos(angle) * scale / n_fft * win,
                            -np.sin(angle) * scale / n_fft * win], axis=0)
    return torch.from_numpy(basis.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def _hamming_wola_norm(n_fft: int, hop: int, frames: int,
                       device: torch.device) -> torch.Tensor:
    """(total,) sum of squared hamming windows over the frames covering
    each sample, floored at 1e-8 (float64 sums on the host)."""
    total = (frames - 1) * hop + n_fft
    win = np.hamming(n_fft)
    norm = np.zeros(total, np.float64)
    for f in range(frames):
        norm[f * hop: f * hop + n_fft] += win ** 2
    return torch.from_numpy(np.maximum(norm, 1e-8).astype(np.float32)).to(
        device)


def stft_hamming(audio: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (B, T) -> (real, imag) each (B, F, frames); centred, reflect
    padding."""
    pad = n_fft // 2
    x = F.pad(audio[:, None, :].float(), (pad, pad), mode="reflect")
    out = F.conv1d(x, _hamming_dft_kernel(n_fft, x.device), stride=hop)
    f = n_fft // 2 + 1
    return out[:, :f], out[:, f:]


def istft_hamming(real: torch.Tensor, imag: torch.Tensor, length: int,
                  n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """WOLA inverse of :func:`stft_hamming` (hamming analysis and
    synthesis): a matmul with the inverse basis, overlap-add on the
    device (``F.fold``), the squared-window normalisation."""
    frames = real.shape[-1]
    spec = torch.cat([real, imag], dim=1).float()            # (B, 2F, T)
    frames_time = torch.einsum("bft,fn->bnt", spec,
                               _hamming_inv_basis(n_fft, spec.device))
    total = (frames - 1) * hop + n_fft
    out = F.fold(frames_time, output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop))[:, 0, 0]
    out = out / _hamming_wola_norm(n_fft, hop, frames, spec.device)[None, :]
    pad = n_fft // 2
    return out[:, pad:pad + length]


@functools.lru_cache(maxsize=4)
def _mel_matrix(n_mels: int, n_fft: int, sr: int,
                device: torch.device) -> torch.Tensor:
    """Kaldi-style mel filterbank (F, n_mels), mel = 1127 ln(1 + f/700)."""
    n_freqs = n_fft // 2 + 1

    def mel(f):
        return 1127.0 * np.log1p(f / 700.0)

    pts = np.linspace(mel(20.0), mel(sr / 2.0), n_mels + 2)
    freqs = mel(np.arange(n_freqs) * sr / n_fft)
    fb = np.zeros((n_freqs, n_mels), np.float64)
    for m in range(n_mels):
        left, center, right = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - left) / (center - left)
        down = (right - freqs) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return torch.from_numpy(fb.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=4)
def _hamming(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.hamming(n_fft).astype(np.float32)).to(device)


def fbank(audio: torch.Tensor, cfg: MossFormer2Config) -> torch.Tensor:
    """audio (B, T) -> log-mel features (B, frames, n_mels).

    Kaldi-style: centred reflect-padded frames, per-frame DC removal,
    preemphasis 0.97 on the framed signal, hamming window, power
    spectrum (rFFT), mel energies, log with a floor of 1e-10; frames
    align 1:1 with :func:`stft_hamming`."""
    pad = cfg.n_fft // 2
    x = F.pad(audio[:, None, :].float(), (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop)          # (B, frames, n_fft)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1] * (1 - 0.97),
                     frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    power = torch.fft.rfft(pre * _hamming(cfg.n_fft, x.device),
                           dim=-1).abs() ** 2
    mels = power @ _mel_matrix(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                               x.device)
    return torch.log(torch.clamp(mels, min=1e-10))


# ---------------------------------------------------------------------------
# primitives (the vendor's module math)
# ---------------------------------------------------------------------------

def _group_norm1(x, w, b, eps: float = 1e-8):
    """GroupNorm(1, C) on (B, S, C): over (S, C), population variance."""
    mu = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps)


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _dw_conv_seq(x, w):
    """Depthwise conv over the sequence axis, 'same' padding, no bias.
    x (B, S, C); w (C, 1, K)."""
    k = w.shape[-1]
    return F.conv1d(x.transpose(1, 2), w, padding=(k - 1) // 2,
                    groups=w.shape[0]).transpose(1, 2)


def _linear_1x1(x, conv: nn.Conv1d):
    """A kernel-1 Conv1d applied to (B, S, C) as a linear map."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class ScaleNorm(nn.Module):
    """lucidrains ScaleNorm: x / max(||x|| d^-1/2, eps) * g."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True) \
            * (x.shape[-1] ** -0.5)
        return x / torch.clamp(n, min=self.eps) * self.g


class _DepthwiseConv1d(nn.Module):
    def __init__(self, c: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, kernel, groups=c,
                              padding=(kernel - 1) // 2, bias=False)


class _ConvModule(nn.Module):
    def __init__(self, c: int, kernel: int = 17):
        super().__init__()
        # (transpose, depthwise conv): the vendor's indices
        self.sequential = nn.Sequential(nn.Identity(),
                                        _DepthwiseConv1d(c, kernel))


class FFConvM(nn.Module):
    """norm -> Linear -> SiLU -> residual depthwise conv (kernel 17);
    ScaleNorm in the attention blocks, LayerNorm inside the gated FSMN."""

    def __init__(self, d_in: int, d_out: int, scalenorm: bool):
        super().__init__()
        norm = ScaleNorm() if scalenorm else nn.LayerNorm(d_in)
        self.mdl = nn.Sequential(norm, nn.Linear(d_in, d_out), nn.SiLU(),
                                 _ConvModule(d_out), nn.Identity())

    def forward(self, x):
        norm, lin = self.mdl[0], self.mdl[1]
        y = norm(x) if isinstance(norm, ScaleNorm) else _layer_norm(x, norm)
        y = F.silu(lin(y))
        return y + _dw_conv_seq(y, self.mdl[3].sequential[1].conv.weight)


class OffsetScale(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(heads, dim))
        self.beta = nn.Parameter(torch.zeros(heads, dim))


def _rotate_half_interleaved(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


@functools.lru_cache(maxsize=4)
def _rotary_freqs(rope_dim: int, device: torch.device) -> torch.Tensor:
    """theta^(-2i / rope_dim) (float64 on the host, then f32), kept on
    ``device``: a copy from the host in every block would wait for the
    device's queue to drain."""
    return torch.from_numpy((1.0 / (10000.0 ** (
        np.arange(0, rope_dim, 2) / rope_dim))).astype(np.float32)).to(
            device)


def _apply_partial_rotary(x, rope_dim: int):
    """Interleaved-pair RoPE on the first ``rope_dim`` lanes
    (rotary-embedding-torch semantics, theta 10000). x (B, S, d)."""
    freqs = _rotary_freqs(rope_dim, x.device)
    n = x.shape[-2]
    angles = (torch.arange(n, device=x.device, dtype=torch.float32)[:, None]
              * freqs[None, :]).repeat_interleave(2, dim=-1)
    head, tail = x[..., :rope_dim], x[..., rope_dim:]
    head = head * torch.cos(angles) \
        + _rotate_half_interleaved(head) * torch.sin(angles)
    return torch.cat([head, tail], dim=-1)


class FLASH_ShareA_FFConvM(nn.Module):
    def __init__(self, cfg: MossFormer2Config):
        super().__init__()
        self.cfg = cfg
        self.to_hidden = FFConvM(cfg.d_model, 2 * cfg.hidden, True)
        self.to_qk = FFConvM(cfg.d_model, cfg.qk_dim, True)
        self.qk_offset_scale = OffsetScale(cfg.qk_dim)
        self.to_out = FFConvM(cfg.hidden, cfg.d_model, True)

    def forward(self, x):
        cfg = self.cfg
        b, n, d = x.shape
        g = cfg.group_size
        # token shift: the first half of the lanes delayed by one frame
        x_shift = F.pad(x[..., :d // 2], (0, 0, 1, 0))[:, :-1]
        normed = torch.cat([x_shift, x[..., d // 2:]], dim=-1)
        v, u = self.to_hidden(normed).chunk(2, dim=-1)    # each (B, S, h)
        qk = self.to_qk(normed)                           # (B, S, qk)
        # OffsetScale: 4 roles (quad_q, lin_q, quad_k, lin_k)
        os_ = self.qk_offset_scale
        roles = qk[:, :, None, :] * os_.gamma + os_.beta   # (B, S, 4, qk)
        roles = _apply_partial_rotary(
            roles.transpose(1, 2).reshape(b * 4, n, cfg.qk_dim),
            cfg.rope_dim).reshape(b, 4, n, cfg.qk_dim)
        quad_q, lin_q, quad_k, lin_k = roles.unbind(1)
        # pad to a group multiple
        padding = (-n) % g
        ts = [quad_q, lin_q, quad_k, lin_k, v, u]
        if padding:
            ts = [F.pad(t, (0, 0, 0, padding)) for t in ts]
        quad_q, lin_q, quad_k, lin_k, vg, ug = (
            t.reshape(b, -1, g, t.shape[-1]) for t in ts)
        sim = torch.einsum("bgid,bgjd->bgij", quad_q, quad_k) / g
        attn = F.relu(sim) ** 2
        quad_v = torch.einsum("bgij,bgjd->bgid", attn, vg)
        quad_u = torch.einsum("bgij,bgjd->bgid", attn, ug)
        # global linear attention, divided by the unpadded length
        lin_kv = torch.einsum("bgnd,bgne->bde", lin_k, vg) / n
        lin_v = torch.einsum("bgnd,bde->bgne", lin_q, lin_kv)
        lin_ku = torch.einsum("bgnd,bgne->bde", lin_k, ug) / n
        lin_u = torch.einsum("bgnd,bde->bgne", lin_q, lin_ku)
        att_v = (quad_v + lin_v).reshape(b, -1, v.shape[-1])[:, :n]
        att_u = (quad_u + lin_u).reshape(b, -1, u.shape[-1])[:, :n]
        out = (att_u * v) * torch.sigmoid(att_v * u)
        return x + self.to_out(out)


class UniDeepFsmn(nn.Module):
    """Over TIME: x + (proj + depthwise memory conv(proj)). x (B, S, C);
    memory kernel 2 lorder - 1, no bias."""

    def __init__(self, c: int, lorder: int):
        super().__init__()
        self.linear = nn.Linear(c, c)
        self.project = nn.Linear(c, c, bias=False)
        self.conv1 = nn.Conv2d(c, c, (2 * lorder - 1, 1), groups=c,
                               bias=False)

    def forward(self, x):
        p1 = self.project(F.relu(self.linear(x)))
        return x + (p1 + _dw_conv_seq(p1, self.conv1.weight[..., 0]))


class Gated_FSMN(nn.Module):
    def __init__(self, c: int, lorder: int):
        super().__init__()
        self.to_u = FFConvM(c, c, False)
        self.to_v = FFConvM(c, c, False)
        self.fsmn = UniDeepFsmn(c, lorder)


class Gated_FSMN_Block(nn.Module):
    """1x1 conv to the inner width + PReLU -> LayerNorm -> gated FSMN
    (the u stream through the memory, gated by the v stream, plus its
    input) -> LayerNorm -> 1x1 conv back; block residual."""

    def __init__(self, cfg: MossFormer2Config):
        super().__init__()
        d, inner = cfg.d_model, cfg.fsmn_inner
        self.conv1 = nn.Sequential(nn.Conv1d(d, inner, 1), nn.PReLU())
        self.norm1 = nn.LayerNorm(inner)
        self.gated_fsmn = Gated_FSMN(inner, cfg.lorder)
        self.norm2 = nn.LayerNorm(inner)
        self.conv2 = nn.Conv1d(inner, d, 1)

    def forward(self, x):
        y = _prelu(_linear_1x1(x, self.conv1[0]), self.conv1[1].weight)
        y = _layer_norm(y, self.norm1)
        gf = self.gated_fsmn
        y2 = gf.to_v(y) * gf.fsmn(gf.to_u(y)) + y
        y2 = _layer_norm(y2, self.norm2)
        return x + _linear_1x1(y2, self.conv2)


class MossformerBlock_GFSMN(nn.Module):
    def __init__(self, cfg: MossFormer2Config):
        super().__init__()
        self.layers = nn.ModuleList([FLASH_ShareA_FFConvM(cfg)
                                     for _ in range(cfg.num_blocks)])
        self.fsmn = nn.ModuleList([Gated_FSMN_Block(cfg)
                                   for _ in range(cfg.num_blocks)])


class MossFormerM(nn.Module):
    def __init__(self, cfg: MossFormer2Config):
        super().__init__()
        self.mossformerM = MossformerBlock_GFSMN(cfg)
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-6)


class Computation_Block(nn.Module):
    def __init__(self, cfg: MossFormer2Config):
        super().__init__()
        self.intra_mdl = MossFormerM(cfg)
        self.intra_norm = nn.GroupNorm(1, cfg.d_model, eps=1e-8)


class ScaledSinuEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        inv = (1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))).astype(
            np.float32)
        self.register_buffer("inv_freq", torch.from_numpy(inv),
                             persistent=False)

    def forward(self, n: int):
        ang = torch.arange(n, device=self.inv_freq.device,
                           dtype=torch.float32)[:, None] * self.inv_freq
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) \
            * self.scale


class MossFormer2(nn.Module):
    """The MaskNet. ``forward(feats)``: fbank (B, S, n_mels) -> mask
    (B, S, n_freqs)."""

    def __init__(self, cfg: MossFormer2Config = MOSSFORMER2_SE_48K):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.norm = nn.GroupNorm(1, cfg.n_mels, eps=1e-8)
        self.conv1d_encoder = nn.Conv1d(cfg.n_mels, d, 1, bias=False)
        self.pos_enc = ScaledSinuEmbedding(d)
        self.mdl = Computation_Block(cfg)
        self.conv1d_out = nn.Conv1d(d, d, 1)
        self.conv1_decoder = nn.Conv1d(d, cfg.n_freqs, 1, bias=False)
        self.prelu = nn.PReLU()
        self.output = nn.Sequential(nn.Conv1d(d, d, 1), nn.Tanh())
        self.output_gate = nn.Sequential(nn.Conv1d(d, d, 1), nn.Sigmoid())
        self.requires_grad_(False)

    def forward(self, feats):
        x = _group_norm1(feats, self.norm.weight, self.norm.bias)
        x = _linear_1x1(x, self.conv1d_encoder)
        x = x + self.pos_enc(x.shape[1])
        blocks = self.mdl.intra_mdl.mossformerM
        y = x
        for flash, fsmn in zip(blocks.layers, blocks.fsmn):
            y = fsmn(flash(y))
        y = _layer_norm(y, self.mdl.intra_mdl.norm)
        y = _group_norm1(y, self.mdl.intra_norm.weight,
                         self.mdl.intra_norm.bias)
        y = _prelu(y + x, self.prelu.weight)               # intra skip
        y = _linear_1x1(y, self.conv1d_out)
        y = (torch.tanh(_linear_1x1(y, self.output[0]))
             * torch.sigmoid(_linear_1x1(y, self.output_gate[0])))
        return F.relu(_linear_1x1(y, self.conv1_decoder))


def forward_mask(model: MossFormer2, feats: torch.Tensor) -> torch.Tensor:
    """The mask net in f32, without autograd: (B, S, n_mels) ->
    (B, S, n_freqs)."""
    with torch.inference_mode(), full_f32():
        return model(feats.float())


def enhance(model: MossFormer2, audio: torch.Tensor,
            length: int) -> torch.Tensor:
    """Denoise audio (B, T) at the model's rate -> (B, length): a real
    magnitude mask from fbank features scales the noisy STFT (noisy
    phase kept), then the inverse STFT."""
    cfg = model.cfg
    with torch.inference_mode(), full_f32():
        audio = audio.float()
        mask = model(fbank(audio, cfg))                    # (B, S, F)
        real, imag = stft_hamming(audio, cfg.n_fft, cfg.hop)
        s = min(mask.shape[1], real.shape[-1])
        m = mask.transpose(1, 2)[:, :, :s]
        return istft_hamming(real[:, :, :s] * m, imag[:, :, :s] * m,
                             length, cfg.n_fft, cfg.hop)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: MossFormer2Config = MOSSFORMER2_SE_48K,
                generator: Optional[torch.Generator] = None,
                device="cpu") -> MossFormer2:
    """Random weights with the JAX package's init distribution: linear and
    1x1-conv weights and biases uniform in +-1/sqrt(fan_in), depthwise
    kernels in +-1/sqrt(K), OffsetScale gammas N(0, 0.02^2), unit norms
    and scales, PReLU slopes 0.25. Drawn on the CPU from ``generator``;
    returned on ``device``."""
    model = MossFormer2(cfg)

    def uniform(p, lim):
        p.copy_(torch.rand(p.shape, generator=generator) * (2 * lim) - lim)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                # in x kernel: in for the 1x1 convs and linears, the
                # kernel length for the depthwise convs
                fan = mod.weight[0].numel()
                uniform(mod.weight, fan ** -0.5)
                if mod.bias is not None:
                    uniform(mod.bias, fan ** -0.5)
            elif isinstance(mod, nn.PReLU):
                mod.weight.fill_(0.25)
            elif isinstance(mod, OffsetScale):
                mod.gamma.copy_(torch.randn(mod.gamma.shape,
                                            generator=generator) * 0.02)
    return model.to(device)


# ---------------------------------------------------------------------------
# the JAX package's tree and the vendor state dict
# ---------------------------------------------------------------------------

_MM = "mdl.intra_mdl.mossformerM"


def _ffconvm_entries(base: str, path: Tuple, index: int,
                     scalenorm: bool) -> List[Entry]:
    norm = ([(f"{base}.mdl.0.g", path + ("norm", "g"), index, "scalar")]
            if scalenorm else
            [(f"{base}.mdl.0.weight", path + ("norm", "w"), index, "id"),
             (f"{base}.mdl.0.bias", path + ("norm", "b"), index, "id")])
    return norm + [
        (f"{base}.mdl.1.weight", path + ("w",), index, "T"),
        (f"{base}.mdl.1.bias", path + ("b",), index, "id"),
        (f"{base}.mdl.3.sequential.1.conv.weight", path + ("conv_w",),
         index, "dw")]


def _entries(cfg: MossFormer2Config) -> List[Entry]:
    out: List[Entry] = [
        ("norm.weight", ("norm_w",), None, "id"),
        ("norm.bias", ("norm_b",), None, "id"),
        ("conv1d_encoder.weight", ("enc_w",), None, "c1x1"),
        ("pos_enc.scale", ("pos_scale",), None, "scalar"),
        ("mdl.intra_mdl.norm.weight", ("mossformer_norm_w",), None, "id"),
        ("mdl.intra_mdl.norm.bias", ("mossformer_norm_b",), None, "id"),
        ("mdl.intra_norm.weight", ("intra_norm_w",), None, "id"),
        ("mdl.intra_norm.bias", ("intra_norm_b",), None, "id"),
        ("prelu.weight", ("prelu",), None, "scalar"),
        ("conv1d_out.weight", ("out_w",), None, "c1x1"),
        ("conv1d_out.bias", ("out_b",), None, "id"),
        ("output.0.weight", ("gate_t_w",), None, "c1x1"),
        ("output.0.bias", ("gate_t_b",), None, "id"),
        ("output_gate.0.weight", ("gate_s_w",), None, "c1x1"),
        ("output_gate.0.bias", ("gate_s_b",), None, "id"),
        ("conv1_decoder.weight", ("dec_w",), None, "c1x1")]
    fl, fb = ("blocks", "flash"), ("blocks", "fsmn_block")
    for i in range(cfg.num_blocks):
        lb, fs = f"{_MM}.layers.{i}", f"{_MM}.fsmn.{i}"
        out += _ffconvm_entries(f"{lb}.to_hidden", fl + ("to_hidden",), i,
                                True)
        out += _ffconvm_entries(f"{lb}.to_qk", fl + ("to_qk",), i, True)
        out += _ffconvm_entries(f"{lb}.to_out", fl + ("to_out",), i, True)
        out += [(f"{lb}.qk_offset_scale.gamma", fl + ("gamma",), i, "id"),
                (f"{lb}.qk_offset_scale.beta", fl + ("beta",), i, "id"),
                (f"{fs}.conv1.0.weight", fb + ("conv1_w",), i, "c1x1"),
                (f"{fs}.conv1.0.bias", fb + ("conv1_b",), i, "id"),
                (f"{fs}.conv1.1.weight", fb + ("prelu1",), i, "scalar"),
                (f"{fs}.norm1.weight", fb + ("norm1_w",), i, "id"),
                (f"{fs}.norm1.bias", fb + ("norm1_b",), i, "id"),
                (f"{fs}.norm2.weight", fb + ("norm2_w",), i, "id"),
                (f"{fs}.norm2.bias", fb + ("norm2_b",), i, "id"),
                (f"{fs}.conv2.weight", fb + ("conv2_w",), i, "c1x1"),
                (f"{fs}.conv2.bias", fb + ("conv2_b",), i, "id")]
        out += _ffconvm_entries(f"{fs}.gated_fsmn.to_u", fb + ("to_u",), i,
                                False)
        out += _ffconvm_entries(f"{fs}.gated_fsmn.to_v", fb + ("to_v",), i,
                                False)
        gf = f"{fs}.gated_fsmn.fsmn"
        out += [(f"{gf}.linear.weight", fb + ("fsmn", "lin_w"), i, "T"),
                (f"{gf}.linear.bias", fb + ("fsmn", "lin_b"), i, "id"),
                (f"{gf}.project.weight", fb + ("fsmn", "proj_w"), i, "T"),
                (f"{gf}.conv1.weight", fb + ("fsmn", "conv_w"), i, "dw2")]
    return out


def tree_from_module(model: MossFormer2) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves; matrices (in, out),
    blocks stacked on a leading axis)."""
    return tree_from_state_dict(model.state_dict(), _entries(model.cfg))


def params_from_jax(tree: Mapping[str, Any], cfg: MossFormer2Config,
                    device="cpu") -> MossFormer2:
    """The JAX package's parameter tree -> :class:`MossFormer2` on
    ``device``."""
    sd = state_dict_from_tree(tree, _entries(cfg))
    return load_module(MossFormer2(cfg), sd).to(device)


_PREFIXES = ("model.mossformer.", "mossformer.", "")


def config_from_state_dict(sd: Mapping[str, Any]) -> MossFormer2Config:
    """The geometry of a bare MaskNet state dict, from the tensors."""
    enc = tuple(sd["conv1d_encoder.weight"].shape)         # (d, mels, 1)
    n_freqs = tuple(sd["conv1_decoder.weight"].shape)[0]   # (F, d, 1)
    n_blocks = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(rf"{_MM}\.layers\.(\d+)\.", k)))
    qk = sd[f"{_MM}.layers.0.qk_offset_scale.gamma"].shape[-1]
    hidden2 = sd[f"{_MM}.layers.0.to_hidden.mdl.1.weight"].shape[0]
    inner = sd[f"{_MM}.fsmn.0.conv1.0.weight"].shape[0]
    lorder = (sd[f"{_MM}.fsmn.0.gated_fsmn.fsmn.conv1.weight"].shape[2]
              + 1) // 2
    n_fft = (n_freqs - 1) * 2              # mask bins fix the STFT size
    return MossFormer2Config(
        n_mels=enc[1], d_model=enc[0], n_freqs=n_freqs, num_blocks=n_blocks,
        qk_dim=qk, rope_dim=min(32, qk), expansion=hidden2 // enc[0],
        fsmn_inner=inner, lorder=lorder, n_fft=n_fft,
        hop=max(1, n_fft // 5),            # the vendor's 1920/384 ratio
        sample_rate=SAMPLE_RATE if n_freqs == 961 else 16_000)


def params_from_torch_state_dict(
        sd: Mapping[str, Any], cfg: Optional[MossFormer2Config] = None,
        device="cpu") -> Tuple[MossFormer2, MossFormer2Config]:
    """Bind a ClearerVoice-Studio ``MossFormer2_SE_48K`` state dict (the
    published ``model.mossformer.`` prefix or a bare MaskNet dict);
    returns (model on ``device``, cfg), the cfg inferred from the tensors
    unless given."""
    for pref in _PREFIXES:
        if f"{pref}norm.weight" in sd:
            if pref:
                sd = {k[len(pref):]: v for k, v in sd.items()
                      if k.startswith(pref)}
            break
    else:
        raise ValueError("unrecognized MossFormer2 state dict "
                         f"(no <prefix>norm.weight among {len(sd)} keys)")
    cfg = cfg or config_from_state_dict(sd)
    return load_module(MossFormer2(cfg), sd).to(device), cfg


# ---------------------------------------------------------------------------
# checkpoint IO
# ---------------------------------------------------------------------------

def save_params(path: str, model: MossFormer2) -> None:
    """Write the JAX package's ``.npz`` layout (``a/0/w`` keys, the config
    under ``__meta__``)."""
    from whisperjav_tpu_torch.utils.pytree_npz import save_pytree

    save_pytree(path, tree_from_module(model),
                meta=dataclasses.asdict(model.cfg))


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[MossFormer2, MossFormer2Config]:
    """``.npz`` (the JAX package's layout) or a torch ``.pt|.pth|.ckpt|
    .bin`` state dict; returns (model on ``device``, cfg)."""
    p = str(path)
    if p.endswith(".npz"):
        from whisperjav_tpu_torch.utils.pytree_npz import load_pytree

        tree, meta = load_pytree(p)
        if meta is None:
            raise ValueError(f"{p}: missing config metadata")
        cfg = MossFormer2Config(**meta)
        return params_from_jax(tree, cfg, device), cfg
    sd = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return params_from_torch_state_dict(sd, device=device)
