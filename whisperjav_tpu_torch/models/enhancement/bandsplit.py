"""Band-split dual-path transformer (the legacy enhancement stand-in) in
PyTorch.

Counterpart of ``whisperjav_tpu/models/enhancement/bandsplit.py``, the
tree that ClearVoice's backend still loads from a legacy ``.npz``: STFT
-> mel-spaced frequency bands -> per-band linear embeddings ->
alternating pre-norm transformer blocks across time (per band) and
across bands (per frame), GPT-NeoX rotary positions -> per-band tanh
complex masks -> ISTFT.

:class:`BandSplitNet` holds its tensors under the JAX package's tree
names (``band_in.0.w``, ``time_blocks.2.wq``, ...: matrices (in, out)),
which are also the keys of its ``__tree__`` ``.npz`` layout, so a file
either package writes loads in the other. The forward pass is f32 with
no TF32; RMSNorm and rotary positions are the port's Qwen primitives,
the same functions as the JAX Qwen model's that the JAX module borrows.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.enhancement._treemap import (
    listify, load_module,
)
from whisperjav_tpu_torch.models.qwen.model import rms_norm, rope, rope_angles
from whisperjav_tpu_torch.ops.stft import istft, stft
from whisperjav_tpu_torch.utils.precision import full_f32


@dataclass(frozen=True)
class BandSplitConfig:
    sample_rate: int = 44_100
    n_fft: int = 2048
    hop: int = 512
    n_bands: int = 24
    d_model: int = 96
    n_heads: int = 4
    n_layers: int = 4            # pairs of (time block, band block)
    target: str = "vocals"       # vocals (keep mask) | noise (residual)


@functools.lru_cache(maxsize=4)
def band_edges(n_freqs: int, n_bands: int) -> Tuple[Tuple[int, int], ...]:
    """Mel-spaced frequency band partition covering [0, n_freqs)."""
    pts = np.unique(np.round(
        (np.exp(np.linspace(0, np.log(n_freqs), n_bands + 1)) - 1)
    ).astype(int))
    pts = np.clip(pts, 0, n_freqs)
    pts[0], pts[-1] = 0, n_freqs
    while len(pts) < n_bands + 1:   # ensure exactly n_bands bands
        gaps = np.diff(pts)
        i = int(np.argmax(gaps))
        pts = np.insert(pts, i + 1, pts[i] + gaps[i] // 2)
    return tuple((int(a), int(b)) for a, b in zip(pts[:-1], pts[1:]))


class _Affine(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))


class _Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(d))
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.zeros(d, d)))
        self.ln2 = nn.Parameter(torch.ones(d))
        self.w1 = nn.Parameter(torch.zeros(d, 4 * d))
        self.w2 = nn.Parameter(torch.zeros(4 * d, d))


def _attn_block(x: torch.Tensor, p: _Block, n_heads: int) -> torch.Tensor:
    """Pre-norm transformer block with RoPE over axis 1. x (N, S, d)."""
    n, s, d = x.shape
    h = rms_norm(x, p.ln1, 1e-6)
    cos, sin = rope_angles(torch.arange(s, device=x.device),
                           d // n_heads, 10_000.0)

    def heads(t):
        return t.reshape(n, s, n_heads, d // n_heads)

    q = rope(heads(h @ p.wq), cos, sin)
    k = rope(heads(h @ p.wk), cos, sin)
    v = heads(h @ p.wv)
    scale = (d // n_heads) ** -0.5
    a = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q * scale, k), dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", a, v)
    x = x + o.reshape(n, s, d) @ p.wo
    h = rms_norm(x, p.ln2, 1e-6)
    return x + F.gelu(h @ p.w1) @ p.w2


class BandSplitNet(nn.Module):
    def __init__(self, cfg: BandSplitConfig = BandSplitConfig()):
        super().__init__()
        self.cfg = cfg
        edges = band_edges(cfg.n_fft // 2 + 1, cfg.n_bands)
        d = cfg.d_model
        self.band_in = nn.ModuleList([_Affine(2 * (b - a), d)
                                      for a, b in edges])
        self.band_out = nn.ModuleList([_Affine(d, 2 * (b - a))
                                       for a, b in edges])
        self.time_blocks = nn.ModuleList([_Block(d)
                                          for _ in range(cfg.n_layers)])
        self.band_blocks = nn.ModuleList([_Block(d)
                                          for _ in range(cfg.n_layers)])
        self.requires_grad_(False)

    def forward(self, audio: torch.Tensor, length: int) -> torch.Tensor:
        cfg = self.cfg
        real, imag = stft(audio, cfg.n_fft, cfg.hop)       # (B, F, T)
        b, n_freqs, t = real.shape
        edges = band_edges(n_freqs, cfg.n_bands)
        # band-split embeddings -> (B, n_bands, T, d)
        x = torch.stack([
            torch.cat([real[:, a:e], imag[:, a:e]], dim=1).transpose(1, 2)
            @ pin.w + pin.b for (a, e), pin in zip(edges, self.band_in)],
            dim=1)
        nb, d = cfg.n_bands, cfg.d_model
        for tb, bb in zip(self.time_blocks, self.band_blocks):
            # across time: bands folded into the batch
            x = _attn_block(x.reshape(b * nb, t, d), tb, cfg.n_heads)
            x = x.reshape(b, nb, t, d)
            # across bands: time folded into the batch
            x = _attn_block(x.transpose(1, 2).reshape(b * t, nb, d), bb,
                            cfg.n_heads)
            x = x.reshape(b, t, nb, d).transpose(1, 2)
        # per-band complex masks -> the masked spectrum
        out_r, out_i = [], []
        for bi, ((a, e), pout) in enumerate(zip(edges, self.band_out)):
            width = e - a
            m = torch.tanh(x[:, bi] @ pout.w + pout.b)     # (B, T, 2*width)
            mr = m[..., :width].transpose(1, 2)
            mi = m[..., width:].transpose(1, 2)
            out_r.append(real[:, a:e] * mr - imag[:, a:e] * mi)
            out_i.append(real[:, a:e] * mi + imag[:, a:e] * mr)
        return istft(torch.cat(out_r, dim=1), torch.cat(out_i, dim=1),
                     length, cfg.n_fft, cfg.hop)


def apply(model: BandSplitNet, audio: torch.Tensor,
          length: int) -> torch.Tensor:
    """audio (B, length) -> separated/enhanced audio (B, length), f32,
    without autograd."""
    with torch.inference_mode(), full_f32():
        return model(audio.float(), length)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init_params(cfg: BandSplitConfig = BandSplitConfig(),
                generator: Optional[torch.Generator] = None,
                device="cpu") -> BandSplitNet:
    """Random weights with the JAX package's init distribution: matrices
    N(0, 1/fan_in), zero biases, unit norms. Drawn on the CPU from
    ``generator``; returned on ``device``."""
    model = BandSplitNet(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[0] ** -0.5)
    return model.to(device)


def _structure(flat: Dict[str, np.ndarray]):
    """The ``__tree__`` record of dotted keys: nested dicts, lists where
    every key of a level is an index, "leaf" at the arrays."""
    tree: Dict = {}
    for key in flat:
        node, parts = tree, key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = "leaf"
    return listify(tree)


def save_params(path: str, model: BandSplitNet) -> None:
    """Write the JAX package's layout: every leaf under its dotted tree
    key, the structure as JSON under ``__tree__``."""
    flat = {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}
    np.savez(path, __tree__=json.dumps(_structure(flat)), **flat)


def load_params(path: str, cfg: BandSplitConfig = BandSplitConfig(),
                device="cpu") -> BandSplitNet:
    """Read the ``__tree__`` layout into a :class:`BandSplitNet` of
    ``cfg`` on ``device``."""
    data = np.load(path, allow_pickle=False)
    if "__tree__" not in data.files:
        raise ValueError(f"{path}: no __tree__ record")
    return load_module(BandSplitNet(cfg), {
        k: data[k] for k in data.files if k != "__tree__"}).to(device)
