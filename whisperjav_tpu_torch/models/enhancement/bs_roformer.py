"""Checkpoint-faithful BS-RoFormer (band-split RoFormer) in PyTorch.

Counterpart of ``whisperjav_tpu/models/enhancement/bs_roformer.py``: the
lucidrains ``BSRoformer`` the reference's vocal isolator loads (stereo
STFT, n_fft 2048, hop 441 at 44.1 kHz; channels folded into frequency
rows; per-band RMSNorm -> Linear; ``depth`` layers of a transformer
across time per band, then across bands per frame, with
interleaved-pair RoPE, per-head sigmoid gates and exact GELU; a final
RMSNorm; a per-band tanh MLP mask head with GLU; complex mask x STFT ->
ISTFT).

:class:`BSRoformer` holds its tensors under the vendor's module names
(``band_split.to_features.{i}.0.gamma``,
``layers.{d}.{k}.layers.{l}.0.to_qkv.weight``,
``mask_estimators.{s}.to_freqs.{i}.0.{2j}.weight``, ...), so a published
state dict loads with ``load_state_dict``; the JAX package's ``lax.scan``
over depth is a ``ModuleList``. :func:`params_from_jax` and
:func:`save_params` read and write the JAX package's parameter tree and
its ``.npz`` layout, so a file either package writes loads in the other.

The forward pass is f32 with no TF32, as the JAX package computes it.
The time branch's attention holds (bands, heads, T, T) f32 logits (at
the viperx widths, 62 x 8 x 801^2 for an 8 s chunk: 1.19 GiB); it runs
over pieces whose logits take at most ``ATTN_PIECE_BYTES``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.enhancement._treemap import (
    Entry, load_module, state_dict_from_tree, tree_from_state_dict,
)
from whisperjav_tpu_torch.ops.stft import istft, stft
from whisperjav_tpu_torch.utils.precision import full_f32

# the largest f32 logits block of one attention piece
ATTN_PIECE_BYTES = 1 << 30

# 24x2 + 12x4 + 8x12 + 8x24 + 8x48 + 128 + 129 = 1025 = 2048 // 2 + 1
VIPERX_BANDS: Tuple[int, ...] = (
    (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128, 129)
)


@dataclass(frozen=True)
class BSRoformerConfig:
    dim: int = 512
    depth: int = 12
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    freqs_per_bands: Tuple[int, ...] = VIPERX_BANDS
    n_fft: int = 2048
    hop: int = 441
    mask_estimator_depth: int = 2
    mlp_expansion_factor: int = 4
    sample_rate: int = 44_100
    rotary_theta: float = 10_000.0

    @property
    def channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def dim_inputs(self) -> Tuple[int, ...]:
        # per-band feature width: bins x channels x (real, imag)
        return tuple(2 * f * self.channels for f in self.freqs_per_bands)


# tiny config for tests
BSR_TEST = BSRoformerConfig(
    dim=16, depth=2, stereo=False, heads=2, dim_head=8, ff_mult=2,
    freqs_per_bands=(2, 2, 2, 2, 4, 4, 8, 9), n_fft=64, hop=16,
    mask_estimator_depth=1, mlp_expansion_factor=2, sample_rate=16_000)


def default_rotary(cfg: BSRoformerConfig) -> np.ndarray:
    """theta^(-2i / dim_head), i < dim_head / 2 (float64 on the host)."""
    return 1.0 / (cfg.rotary_theta
                  ** (np.arange(0, cfg.dim_head, 2) / cfg.dim_head))


# ---------------------------------------------------------------------------
# modules (the lucidrains hierarchy)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """``F.normalize(x) * sqrt(d) * gamma``."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.normalize(x, dim=-1) * (x.shape[-1] ** 0.5) * self.gamma


class RotaryEmbedding(nn.Module):
    def __init__(self, cfg: BSRoformerConfig):
        super().__init__()
        self.freqs = nn.Parameter(torch.from_numpy(
            default_rotary(cfg).astype(np.float32)), requires_grad=False)


def _rotate_half_interleaved(x):
    """rotary-embedding-torch pairing: adjacent (even, odd) lanes."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _apply_rotary(x, freqs):
    """x (..., n, d), freqs (d/2,) -> interleaved-pair RoPE."""
    n = x.shape[-2]
    angles = (torch.arange(n, device=x.device, dtype=torch.float32)[:, None]
              * freqs[None, :]).repeat_interleave(2, dim=-1)
    return x * torch.cos(angles) + _rotate_half_interleaved(x) \
        * torch.sin(angles)


class Attention(nn.Module):
    """Gated RoPE attention over axis -2 (the rotary frequencies are the
    model's, passed in)."""

    def __init__(self, cfg: BSRoformerConfig):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads, self.dim_head = cfg.heads, cfg.dim_head
        self.norm = RMSNorm(cfg.dim)
        self.to_qkv = nn.Linear(cfg.dim, 3 * inner, bias=False)
        self.to_gates = nn.Linear(cfg.dim, cfg.heads)
        self.to_out = nn.Sequential(nn.Linear(inner, cfg.dim, bias=False))

    def forward(self, x, freqs):
        h, dh = self.heads, self.dim_head
        y = self.norm(x)
        b, n, _ = y.shape
        qkv = self.to_qkv(y).view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q = _apply_rotary(qkv[0], freqs)                  # (b, h, n, dh)
        k = _apply_rotary(qkv[1], freqs)
        v = qkv[2]
        piece = max(1, ATTN_PIECE_BYTES // (h * n * n * 4))
        out = torch.empty_like(q)
        for a in range(0, b, piece):
            w = torch.softmax(torch.matmul(q[a:a + piece],
                                           k[a:a + piece].transpose(-1, -2))
                              * dh ** -0.5, dim=-1)
            out[a:a + piece] = torch.matmul(w, v[a:a + piece])
            del w
        gates = self.to_gates(y)                          # (b, n, h)
        out = out * torch.sigmoid(gates.transpose(1, 2))[..., None]
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class FeedForward(nn.Module):
    def __init__(self, cfg: BSRoformerConfig):
        super().__init__()
        inner = cfg.dim * cfg.ff_mult
        # RMSNorm, Linear, GELU, (dropout), Linear, (dropout): the
        # vendor's indices
        self.net = nn.Sequential(RMSNorm(cfg.dim), nn.Linear(cfg.dim, inner),
                                 nn.GELU(), nn.Identity(),
                                 nn.Linear(inner, cfg.dim), nn.Identity())

    def forward(self, x):
        return self.net(x)


class Transformer(nn.Module):
    def __init__(self, cfg: BSRoformerConfig, depth: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(cfg), FeedForward(cfg)])
            for _ in range(depth)])

    def forward(self, x, freqs):
        for attn, ff in self.layers:
            x = attn(x, freqs) + x
            x = ff(x) + x
        return x


class BandSplit(nn.Module):
    def __init__(self, cfg: BSRoformerConfig):
        super().__init__()
        self.dim_inputs = list(cfg.dim_inputs)
        self.to_features = nn.ModuleList([
            nn.Sequential(RMSNorm(d), nn.Linear(d, cfg.dim))
            for d in cfg.dim_inputs])

    def forward(self, x):
        xs = x.split(self.dim_inputs, dim=-1)
        return torch.stack([f(v) for f, v in zip(self.to_features, xs)],
                           dim=-2)


def _mlp(dim_in: int, dim_out: int, dim_hidden: int, depth: int):
    dims = (dim_in, *((dim_hidden,) * depth), dim_out)
    net: List[nn.Module] = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        net.append(nn.Linear(a, b))
        if i < len(dims) - 2:
            net.append(nn.Tanh())
    return nn.Sequential(*net)


class MaskEstimator(nn.Module):
    def __init__(self, cfg: BSRoformerConfig):
        super().__init__()
        hidden = cfg.dim * cfg.mlp_expansion_factor
        self.to_freqs = nn.ModuleList([
            nn.Sequential(_mlp(cfg.dim, 2 * d, hidden,
                               cfg.mask_estimator_depth), nn.GLU(dim=-1))
            for d in cfg.dim_inputs])

    def forward(self, x):
        return torch.cat([f(x[..., i, :])
                          for i, f in enumerate(self.to_freqs)], dim=-1)


class BSRoformer(nn.Module):
    """``forward(spec)``: (B, FS, T, 2) real/imag spectrogram, FS = bins x
    channels (channel minor) -> masks (B, num_stems, FS, T, 2)."""

    def __init__(self, cfg: BSRoformerConfig = BSRoformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.time_rotary_embed = RotaryEmbedding(cfg)
        self.freq_rotary_embed = RotaryEmbedding(cfg)
        self.layers = nn.ModuleList([
            nn.ModuleList([Transformer(cfg, cfg.time_transformer_depth),
                           Transformer(cfg, cfg.freq_transformer_depth)])
            for _ in range(cfg.depth)])
        self.final_norm = RMSNorm(cfg.dim)
        self.band_split = BandSplit(cfg)
        self.mask_estimators = nn.ModuleList([
            MaskEstimator(cfg) for _ in range(cfg.num_stems)])
        self.requires_grad_(False)

    def forward(self, spec):
        cfg = self.cfg
        b, fs, t, _ = spec.shape
        x = self.band_split(spec.permute(0, 2, 1, 3).reshape(b, t, fs * 2))
        nb = x.shape[2]                                  # (B, T, bands, D)
        for time_tr, freq_tr in self.layers:
            y = x.permute(0, 2, 1, 3).reshape(b * nb, t, cfg.dim)
            y = time_tr(y, self.time_rotary_embed.freqs)
            x = y.reshape(b, nb, t, cfg.dim).permute(0, 2, 1, 3)
            y = freq_tr(x.reshape(b * t, nb, cfg.dim),
                        self.freq_rotary_embed.freqs)
            x = y.reshape(b, t, nb, cfg.dim)
        x = self.final_norm(x)
        masks = torch.stack([est(x) for est in self.mask_estimators], dim=1)
        masks = masks.reshape(b, cfg.num_stems, t, fs, 2)
        return masks.permute(0, 1, 3, 2, 4)


# ---------------------------------------------------------------------------
# forward functions
# ---------------------------------------------------------------------------

def forward_spec(model: BSRoformer, spec: torch.Tensor) -> torch.Tensor:
    """Complex-mask prediction on a precomputed spectrogram, f32, no
    autograd. spec (B, FS, T, 2) -> masks (B, num_stems, FS, T, 2)."""
    with torch.inference_mode(), full_f32():
        return model(spec.float())


def separate(model: BSRoformer, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, C, T) -> stems (B, num_stems, C, T): masking in the
    complex STFT domain, centred Hann analysis and synthesis."""
    cfg = model.cfg
    b, c, length = audio.shape
    if c != cfg.channels:
        raise ValueError(f"audio has {c} channels, the model {cfg.channels}")
    with torch.inference_mode(), full_f32():
        r, i = stft(audio.reshape(b * c, length).float(), cfg.n_fft, cfg.hop)
        f, t = r.shape[1], r.shape[2]
        spec = torch.stack([r, i], dim=-1).reshape(b, c, f, t, 2)
        # fold channels into frequency rows: 'b s f t c -> b (f s) t c'
        spec = spec.permute(0, 2, 1, 3, 4).reshape(b, f * c, t, 2)
        masks = model(spec)                          # (B, stems, f*c, T, 2)
        sr, si = spec[..., 0][:, None], spec[..., 1][:, None]
        mr, mi = masks[..., 0], masks[..., 1]
        outr = (sr * mr - si * mi).reshape(b, cfg.num_stems, f, c, t)
        outi = (sr * mi + si * mr).reshape(b, cfg.num_stems, f, c, t)
        # unfold: 'b n (f s) t -> (b n s) f t'
        flat_r = outr.permute(0, 1, 3, 2, 4).reshape(-1, f, t)
        flat_i = outi.permute(0, 1, 3, 2, 4).reshape(-1, f, t)
        out = istft(flat_r, flat_i, length, cfg.n_fft, cfg.hop)
        return out.reshape(b, cfg.num_stems, c, length)


def isolate_vocals(model: BSRoformer, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) mono or (B, C, T) -> the vocal stem, the input's shape (mono
    is duplicated to the model's stereo and averaged back)."""
    mono = audio.ndim == 2
    if mono:
        audio = audio[:, None, :]
    if audio.shape[1] == 1 and model.cfg.channels == 2:
        audio = audio.repeat(1, 2, 1)
    out = separate(model, audio)[:, 0]
    return out.mean(dim=1) if mono else out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: BSRoformerConfig = BSRoformerConfig(),
                generator: Optional[torch.Generator] = None,
                device="cpu") -> BSRoformer:
    """Random weights with the JAX package's init distribution: every
    linear weight and bias uniform in +-1/sqrt(fan_in), unit norms, the
    default rotary frequencies. Drawn on the CPU from ``generator``;
    returned on ``device``."""
    model = BSRoformer(cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                lim = mod.in_features ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator)
                                * (2 * lim) - lim)
    return model.to(device)


# ---------------------------------------------------------------------------
# the JAX package's tree and the vendor state dict
# ---------------------------------------------------------------------------

def _entries(cfg: BSRoformerConfig) -> List[Entry]:
    out: List[Entry] = []
    for i in range(len(cfg.dim_inputs)):
        pre = f"band_split.to_features.{i}"
        out += [(f"{pre}.0.gamma", ("band_split", i, "gamma"), None, "id"),
                (f"{pre}.1.weight", ("band_split", i, "w"), None, "T"),
                (f"{pre}.1.bias", ("band_split", i, "b"), None, "id")]
    for k, branch, inner in ((0, "time", cfg.time_transformer_depth),
                             (1, "freq", cfg.freq_transformer_depth)):
        for lyr in range(inner):
            at = ("layers", branch, lyr, "attn")
            ff = ("layers", branch, lyr, "ff")
            for d in range(cfg.depth):
                pre = f"layers.{d}.{k}.layers.{lyr}"
                out += [
                    (f"{pre}.0.norm.gamma", at + ("norm_gamma",), d, "id"),
                    (f"{pre}.0.to_qkv.weight", at + ("qkv_w",), d, "T"),
                    (f"{pre}.0.to_gates.weight", at + ("gates_w",), d, "T"),
                    (f"{pre}.0.to_gates.bias", at + ("gates_b",), d, "id"),
                    (f"{pre}.0.to_out.0.weight", at + ("out_w",), d, "T"),
                    (f"{pre}.1.net.0.gamma", ff + ("norm_gamma",), d, "id"),
                    (f"{pre}.1.net.1.weight", ff + ("w1",), d, "T"),
                    (f"{pre}.1.net.1.bias", ff + ("b1",), d, "id"),
                    (f"{pre}.1.net.4.weight", ff + ("w2",), d, "T"),
                    (f"{pre}.1.net.4.bias", ff + ("b2",), d, "id")]
    for s in range(cfg.num_stems):
        for i in range(len(cfg.dim_inputs)):
            for j in range(cfg.mask_estimator_depth + 1):
                pre = f"mask_estimators.{s}.to_freqs.{i}.0.{2 * j}"
                path = ("mask_estimators", s, i, j)
                out += [(f"{pre}.weight", path + ("w",), None, "T"),
                        (f"{pre}.bias", path + ("b",), None, "id")]
    out += [("final_norm.gamma", ("final_norm",), None, "id"),
            ("time_rotary_embed.freqs", ("time_rotary",), None, "id"),
            ("freq_rotary_embed.freqs", ("freq_rotary",), None, "id")]
    return out


def tree_from_module(model: BSRoformer) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves; matrices (in, out),
    layers stacked over depth)."""
    return tree_from_state_dict(model.state_dict(), _entries(model.cfg))


def params_from_jax(tree: Mapping[str, Any], cfg: BSRoformerConfig,
                    device="cpu") -> BSRoformer:
    """The JAX package's parameter tree -> :class:`BSRoformer` on
    ``device``."""
    sd = state_dict_from_tree(tree, _entries(cfg))
    return load_module(BSRoformer(cfg), sd).to(device)


def params_from_torch_state_dict(sd: Mapping[str, Any],
                                 cfg: BSRoformerConfig,
                                 device="cpu") -> BSRoformer:
    """A lucidrains ``BSRoformer`` state dict -> :class:`BSRoformer` on
    ``device`` (k = 0 the time transformer, k = 1 the frequency one;
    missing rotary frequencies take their default)."""
    sd = dict(sd)
    for name in ("time_rotary_embed.freqs", "freq_rotary_embed.freqs"):
        sd.setdefault(name, default_rotary(cfg)[:cfg.dim_head // 2])
    return load_module(BSRoformer(cfg), sd).to(device)


def _shape(t) -> Tuple[int, ...]:
    return tuple(t.shape)


def config_from_state_dict(sd: Mapping[str, Any]) -> BSRoformerConfig:
    """Infer the architecture hyperparameters from a vendor state dict."""
    dim = _shape(sd["final_norm.gamma"])[0]
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("layers."))
    inner = {0: 0, 1: 0}
    for k in sd:
        parts = k.split(".")
        if k.startswith("layers.0.") and parts[3].isdigit():
            branch = int(parts[2])
            if branch in inner:
                inner[branch] = max(inner[branch], int(parts[3]) + 1)
    qkv = _shape(sd["layers.0.0.layers.0.0.to_qkv.weight"])
    heads = _shape(sd["layers.0.0.layers.0.0.to_gates.bias"])[0]
    dim_head = qkv[0] // (3 * heads)
    ff_mult = _shape(sd["layers.0.0.layers.0.1.net.1.weight"])[0] // dim
    n_bands = 1 + max(int(k.split(".")[2]) for k in sd
                      if k.startswith("band_split.to_features."))
    dims_in = [_shape(sd[f"band_split.to_features.{i}.1.weight"])[1]
               for i in range(n_bands)]
    num_stems = 1 + max((int(k.split(".")[1]) for k in sd
                         if k.startswith("mask_estimators.")), default=0)
    mask_linears = 1 + max(
        int(k.split(".")[5]) // 2 for k in sd
        if k.startswith("mask_estimators.0.to_freqs.0.0."))
    # the mask heads' hidden width (the JAX loader keeps the default 4
    # and reads the tensors' shapes; the port's modules need the width)
    expansion = (_shape(sd["mask_estimators.0.to_freqs.0.0.0.weight"])[0]
                 // dim if mask_linears > 1 else 4)
    total = sum(dims_in)
    for stereo, n_fft in ((True, (total // 4 - 1) * 2),
                          (False, (total // 2 - 1) * 2)):
        chans = 2 if stereo else 1
        if (n_fft // 2 + 1) * 2 * chans == total and n_fft > 0:
            freqs = tuple(d // (2 * chans) for d in dims_in)
            return BSRoformerConfig(
                dim=dim, depth=depth, stereo=stereo, num_stems=num_stems,
                time_transformer_depth=inner[0] or 1,
                freq_transformer_depth=inner[1] or 1,
                heads=heads, dim_head=dim_head, ff_mult=ff_mult,
                freqs_per_bands=freqs, n_fft=n_fft,
                mask_estimator_depth=mask_linears - 1,
                mlp_expansion_factor=expansion)
    raise ValueError(f"cannot infer stft size from band dims {dims_in}")


# ---------------------------------------------------------------------------
# checkpoint IO
# ---------------------------------------------------------------------------

def save_params(path: str, model: BSRoformer) -> None:
    """Write the JAX package's ``.npz`` layout (``a/0/w`` keys, the config
    under ``__meta__``)."""
    from whisperjav_tpu_torch.utils.pytree_npz import save_pytree

    save_pytree(path, tree_from_module(model),
                meta=dataclasses.asdict(model.cfg))


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[BSRoformer, BSRoformerConfig]:
    """Load by extension: ``.npz`` (the JAX package's layout), ``.onnx``
    (torch-export initializer names) or a torch ``.pt/.pth/.ckpt/.bin``
    state dict; returns (model on ``device``, cfg)."""
    p = str(path)
    if p.endswith(".npz"):
        from whisperjav_tpu_torch.utils.pytree_npz import load_pytree

        tree, meta = load_pytree(p)
        if meta is None:
            raise ValueError(f"{p}: missing config metadata")
        meta["freqs_per_bands"] = tuple(meta["freqs_per_bands"])
        cfg = BSRoformerConfig(**meta)
        return params_from_jax(tree, cfg, device), cfg
    if p.endswith(".onnx"):
        from whisperjav_tpu_torch.utils.onnx_io import read_initializers

        sd = read_initializers(p)
    else:
        obj = torch.load(p, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        sd = {k[6:] if k.startswith("model.") else k: v
              for k, v in sd.items()}
    cfg = config_from_state_dict(sd)
    return params_from_torch_state_dict(sd, cfg, device), cfg
