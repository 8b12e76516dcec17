"""Checkpoint-faithful FRCRN speech enhancement (ClearVoice FRCRN_SE_16K)
in PyTorch.

Counterpart of ``whisperjav_tpu/models/enhancement/frcrn.py``: ModelScope's
``speech_frcrn_ans_cirm_16k`` denoiser, cascaded complex U-Nets with
frequency-recurrent FSMN blocks predicting a complex ideal ratio mask:

* complex convolutions as two real ones (``conv_re``/``conv_im``):
  ``y_r = conv_re(x_r) - conv_im(x_i)``, ``y_i = conv_re(x_i) +
  conv_im(x_r)``; the decoder's are ``conv_transpose2d`` on the
  ``(in, out, kH, kW)`` weight with padding (2, 1) and output padding
  (1, 0), then cropped to the mirror encoder's size;
* the deep-complex-networks whitening batch norm, from its running
  statistics;
* the FSMN memory: linear -> ReLU -> project -> a depthwise convolution
  over FREQUENCY with +-(lorder-1) context, residual, combined
  complex-linearly;
* ``mask = tanh(unet(x)) + tanh(unet2(unet(x)))``; ``est = spec * mask``
  (complex product), ISTFT (win = fft 640, hop 320, centred Hann).

:class:`FRCRN` holds its tensors under the vendor's canonical names
(``unet.encoders.{i}.conv.conv_re.weight``, ``.bn.running_covar``,
``.fsmn.fsmn_re_L1.linear.weight``, ...); :func:`params_from_jax` and
:func:`save_params` read and write the JAX package's tree and ``.npz``
layout. The forward pass is f32 with no TF32, as the JAX package.
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

SAMPLE_RATE = 16_000
N_FFT = 640
HOP = 320


@dataclass(frozen=True)
class StageGeom:
    """One encoder/decoder stage's conv geometry."""
    c_in: int
    c_out: int
    kernel: Tuple[int, int] = (5, 2)       # (freq, time)
    stride: Tuple[int, int] = (2, 1)
    padding: Tuple[int, int] = (2, 1)
    fsmn: bool = True


@dataclass(frozen=True)
class FRCRNConfig:
    n_fft: int = N_FFT
    hop: int = HOP
    lorder: int = 20                       # FSMN memory half-order
    encoders: Tuple[StageGeom, ...] = ()
    decoders: Tuple[StageGeom, ...] = ()

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def default_config(complexity: int = 45, depth: int = 14,
                   lorder: int = 20) -> FRCRNConfig:
    """The published model's geometry family: ``depth`` total stages
    (depth//2 encoders), channel ladder 1->C->C->2C->2C->2C->128."""
    n = depth // 2
    chans = [1]
    for i in range(n - 1):
        chans.append(complexity if i < 2 else complexity * 2)
    chans.append(128)
    encs = tuple(StageGeom(chans[i], chans[i + 1]) for i in range(n))
    decs = []
    for i in reversed(range(n)):
        skip = chans[i + 1]                # concatenated encoder output
        c_in = chans[i + 1] + (skip if i < n - 1 else 0)
        decs.append(StageGeom(c_in, chans[i], fsmn=i > 0))
    return FRCRNConfig(encoders=encs, decoders=tuple(decs), lorder=lorder)


FRCRN_SE_16K = default_config()

# tiny test config (n_fft 64 -> 33 freq rows, 2 stages)
FRCRN_TEST = FRCRNConfig(
    n_fft=64, hop=16, lorder=3,
    encoders=(StageGeom(1, 4), StageGeom(4, 6)),
    decoders=(StageGeom(6, 4), StageGeom(8, 1, fsmn=False)))

_LEAK = 0.1


# ---------------------------------------------------------------------------
# modules (the vendor's names)
# ---------------------------------------------------------------------------

class ComplexConv2d(nn.Module):
    def __init__(self, geom: StageGeom, transpose: bool = False):
        super().__init__()
        self.geom, self.transpose = geom, transpose
        conv = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.conv_re = conv(geom.c_in, geom.c_out, geom.kernel, geom.stride,
                            geom.padding)
        self.conv_im = conv(geom.c_in, geom.c_out, geom.kernel, geom.stride,
                            geom.padding)

    def _op(self, x, conv):
        g = self.geom
        if self.transpose:
            # one extra frequency row: the caller crops to the mirror
            # encoder's size (stride-2 halving is not uniquely invertible)
            return F.conv_transpose2d(x, conv.weight, conv.bias, g.stride,
                                      g.padding, output_padding=(1, 0))
        return F.conv2d(x, conv.weight, conv.bias, g.stride, g.padding)

    def forward(self, xr, xi):
        yr = self._op(xr, self.conv_re) - self._op(xi, self.conv_im)
        yi = self._op(xi, self.conv_re) + self._op(xr, self.conv_im)
        return yr, yi


class ComplexBatchNorm2d(nn.Module):
    """deep-complex-networks whitening BN, from the running statistics:
    mean (C, 2), covariance (C, 3) [V_rr, V_ii, V_ri], weight (C, 3)
    [W_rr, W_ri, W_ii], bias (C, 2)."""

    def __init__(self, c: int):
        super().__init__()
        w = torch.zeros(c, 3)
        w[:, 0] = w[:, 2] = 1 / np.sqrt(2.0)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(c, 2))
        rc = torch.zeros(c, 3)
        rc[:, 0] = rc[:, 1] = 1 / np.sqrt(2.0)
        self.register_buffer("running_mean", torch.zeros(c, 2))
        self.register_buffer("running_covar", rc)

    def forward(self, xr, xi, eps: float = 1e-5):
        def col(v):
            return v[None, :, None, None]

        vrr = self.running_covar[:, 0] + eps
        vii = self.running_covar[:, 1] + eps
        vri = self.running_covar[:, 2]
        # inverse matrix square root of [[vrr, vri], [vri, vii]]
        s = torch.sqrt(vrr * vii - vri * vri)
        t = torch.sqrt(vrr + vii + 2 * s)
        inv_st = 1.0 / (s * t)
        rrr, rii = col((vii + s) * inv_st), col((vrr + s) * inv_st)
        rri = col(-vri * inv_st)
        xr_h = xr - col(self.running_mean[:, 0])
        xi_h = xi - col(self.running_mean[:, 1])
        wr = rrr * xr_h + rri * xi_h
        wi = rri * xr_h + rii * xi_h
        w_rr, w_ri, w_ii = (col(self.weight[:, j]) for j in range(3))
        return (w_rr * wr + w_ri * wi + col(self.bias[:, 0]),
                w_ri * wr + w_ii * wi + col(self.bias[:, 1]))


class UniDeepFsmn(nn.Module):
    """x (B, C, F, T): linear C->C, ReLU, project (no bias), plus a
    depthwise memory convolution over F; residual."""

    def __init__(self, c: int, lorder: int):
        super().__init__()
        self.lorder = lorder
        self.linear = nn.Linear(c, c)
        self.project = nn.Linear(c, c, bias=False)
        self.conv1 = nn.Conv2d(c, c, (2 * lorder - 1, 1), groups=c,
                               bias=False)

    def forward(self, x):
        h = F.relu(self.linear(x.permute(0, 2, 3, 1)))     # (B, F, T, C)
        pr = self.project(h).permute(0, 3, 1, 2)            # (B, C, F, T)
        mem = F.conv2d(pr, self.conv1.weight,
                       padding=(self.lorder - 1, 0), groups=pr.shape[1])
        return x + pr + mem


class ComplexUniDeepFsmn(nn.Module):
    def __init__(self, c: int, lorder: int):
        super().__init__()
        self.fsmn_re_L1 = UniDeepFsmn(c, lorder)
        self.fsmn_im_L1 = UniDeepFsmn(c, lorder)

    def forward(self, xr, xi):
        rr, ri = self.fsmn_re_L1(xr), self.fsmn_re_L1(xi)
        ir, ii = self.fsmn_im_L1(xr), self.fsmn_im_L1(xi)
        return rr - ii, ri + ir


class _Stage(nn.Module):
    def __init__(self, geom: StageGeom, lorder: int, transpose: bool,
                 bn: bool):
        super().__init__()
        self.conv = ComplexConv2d(geom, transpose)
        if bn:
            self.bn = ComplexBatchNorm2d(geom.c_out)
        if geom.fsmn:
            self.fsmn = ComplexUniDeepFsmn(geom.c_out, lorder)

    def post(self, xr, xi):
        """BN, leaky ReLU, then the FSMN where the stage has one."""
        xr, xi = self.bn(xr, xi)
        xr, xi = F.leaky_relu(xr, _LEAK), F.leaky_relu(xi, _LEAK)
        if hasattr(self, "fsmn"):
            xr, xi = self.fsmn(xr, xi)
        return xr, xi


class UNet(nn.Module):
    def __init__(self, cfg: FRCRNConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.decoders)
        self.encoders = nn.ModuleList([_Stage(g, cfg.lorder, False, True)
                                       for g in cfg.encoders])
        self.decoders = nn.ModuleList([
            _Stage(g, cfg.lorder, True, i < n - 1)
            for i, g in enumerate(cfg.decoders)])

    def forward(self, xr, xi):
        skips = []
        for enc in self.encoders:
            xr, xi = enc.post(*enc.conv(xr, xi))
            skips.append((xr, xi))
        n = len(self.decoders)
        for i, dec in enumerate(self.decoders):
            if i > 0:                       # concat mirror-encoder output
                sr, si = skips[n - 1 - i]
                xr = torch.cat([xr, sr], dim=1)
                xi = torch.cat([xi, si], dim=1)
            xr, xi = dec.conv(xr, xi)
            # the transposed conv can overshoot the mirror size by a row
            if i < n - 1:
                f_tgt, t_tgt = skips[n - 2 - i][0].shape[2:]
                xr, xi = xr[:, :, :f_tgt, :t_tgt], xi[:, :, :f_tgt, :t_tgt]
                xr, xi = dec.post(xr, xi)
            else:
                xr = xr[:, :, :self.cfg.n_freqs]
                xi = xi[:, :, :self.cfg.n_freqs]
        return xr, xi


class FRCRN(nn.Module):
    """``forward(spec_r, spec_i)``: noisy spectrogram (B, F, T) re/im ->
    the cIRM (B, F, T) re/im."""

    def __init__(self, cfg: FRCRNConfig = FRCRN_SE_16K):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet(cfg)
        self.unet2 = UNet(cfg)
        self.requires_grad_(False)

    def forward(self, spec_r, spec_i):
        u1r, u1i = self.unet(spec_r[:, None], spec_i[:, None])
        u2r, u2i = self.unet2(u1r, u1i)
        return ((torch.tanh(u1r) + torch.tanh(u2r))[:, 0],
                (torch.tanh(u1i) + torch.tanh(u2i))[:, 0])


def forward_spec(model: FRCRN, spec_r: torch.Tensor, spec_i: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cascade's mask in f32, without autograd."""
    with torch.inference_mode(), full_f32():
        return model(spec_r.float(), spec_i.float())


def denoise(model: FRCRN, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) at 16 kHz -> enhanced audio, same shape: STFT, the
    cascade's complex ratio mask, masked spectrogram, ISTFT."""
    cfg = model.cfg
    length = audio.shape[-1]
    with torch.inference_mode(), full_f32():
        sr, si = stft(audio.float(), cfg.n_fft, cfg.hop)
        mr, mi = model(sr, si)
        return istft(sr * mr - si * mi, sr * mi + si * mr, length,
                     cfg.n_fft, cfg.hop)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: FRCRNConfig = FRCRN_SE_16K,
                generator: Optional[torch.Generator] = None,
                device="cpu") -> FRCRN:
    """Random weights with the JAX package's init distribution: conv
    weights and biases uniform in +-1/sqrt(c_in kH kW), FSMN matrices
    and memory kernels in +-1/sqrt(c), zero FSMN biases, the identity
    whitening BN. Drawn on the CPU from ``generator``; returned on
    ``device``."""
    model = FRCRN(cfg)

    def uniform(p, lim):
        p.copy_(torch.rand(p.shape, generator=generator) * (2 * lim) - lim)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ComplexConv2d):
                g = mod.geom
                lim = (g.c_in * g.kernel[0] * g.kernel[1]) ** -0.5
                for conv in (mod.conv_re, mod.conv_im):
                    uniform(conv.weight, lim)
                    uniform(conv.bias, lim)
            elif isinstance(mod, UniDeepFsmn):
                lim = mod.linear.in_features ** -0.5
                uniform(mod.linear.weight, lim)
                mod.linear.bias.zero_()
                uniform(mod.project.weight, lim)
                uniform(mod.conv1.weight, lim)
    return model.to(device)


# ---------------------------------------------------------------------------
# the JAX package's tree and the vendor state dict
# ---------------------------------------------------------------------------

def _entries(cfg: FRCRNConfig) -> List[Entry]:
    out: List[Entry] = []
    n_dec = len(cfg.decoders)
    for unet in ("unet", "unet2"):
        for kind, geoms in (("encoders", cfg.encoders),
                            ("decoders", cfg.decoders)):
            for i, geom in enumerate(geoms):
                pre, path = f"{unet}.{kind}.{i}", (unet, kind, i)
                for part in ("re", "im"):
                    out += [(f"{pre}.conv.conv_{part}.weight",
                             path + ("conv", f"{part}_w"), None, "id"),
                            (f"{pre}.conv.conv_{part}.bias",
                             path + ("conv", f"{part}_b"), None, "id")]
                if kind == "encoders" or i < n_dec - 1:
                    out += [(f"{pre}.bn.{k}", path + ("bn", k), None, "id")
                            for k in ("weight", "bias", "running_mean",
                                      "running_covar")]
                if geom.fsmn:
                    for part in ("re", "im"):
                        fp = f"{pre}.fsmn.fsmn_{part}_L1"
                        out += [(f"{fp}.{t}", path + ("fsmn", part, leaf),
                                 None, "id")
                                for t, leaf in (("linear.weight", "linear_w"),
                                                ("linear.bias", "linear_b"),
                                                ("project.weight",
                                                 "project_w"),
                                                ("conv1.weight", "conv1_w"))]
    return out


def tree_from_module(model: FRCRN) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves, torch layouts)."""
    return tree_from_state_dict(model.state_dict(), _entries(model.cfg))


def params_from_jax(tree: Mapping[str, Any], cfg: FRCRNConfig,
                    device="cpu") -> FRCRN:
    """The JAX package's parameter tree -> :class:`FRCRN` on ``device``."""
    sd = state_dict_from_tree(tree, _entries(cfg))
    return load_module(FRCRN(cfg), sd).to(device)


#: wrapper prefixes seen on published checkpoints (TorchModel decorator)
VENDOR_PREFIXES = ("model.", "module.", "frcrn.")


def _strip_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    keys = list(sd)
    for pre in VENDOR_PREFIXES:
        if any(k.startswith(pre + "unet") for k in keys):
            return {k[len(pre):] if k.startswith(pre) else k: v
                    for k, v in sd.items()}
    return dict(sd)


def config_from_state_dict(sd: Mapping[str, Any]) -> FRCRNConfig:
    """The geometry of a vendor state dict (prefix stripped): stage
    count, channels, kernel sizes, FSMN presence and memory order from
    the tensors; strides and paddings the published (2, 1)."""
    def stages(kind):
        pre = f"unet.{kind}."
        return sorted({int(k[len(pre):].split(".")[0]) for k in sd
                       if k.startswith(pre)})

    lorder, geoms = None, {}
    for kind, transpose in (("encoders", False), ("decoders", True)):
        geoms[kind] = []
        for i in stages(kind):
            pre = f"unet.{kind}.{i}"
            w = tuple(sd[f"{pre}.conv.conv_re.weight"].shape)
            fsmn = f"{pre}.fsmn.fsmn_re_L1.linear.weight" in sd
            if fsmn:
                lorder = (sd[f"{pre}.fsmn.fsmn_re_L1.conv1.weight"]
                          .shape[2] + 1) // 2
            c_in, c_out = (w[0], w[1]) if transpose else (w[1], w[0])
            geoms[kind].append(StageGeom(c_in, c_out, kernel=(w[2], w[3]),
                                         fsmn=fsmn))
    if not geoms["encoders"]:
        raise ValueError(f"no 'unet.encoders.*' tensors found; keys like: "
                         f"{sorted(sd)[:4]}")
    return FRCRNConfig(encoders=tuple(geoms["encoders"]),
                       decoders=tuple(geoms["decoders"]),
                       lorder=lorder or 20)


def params_from_torch_state_dict(
        sd: Mapping[str, Any], cfg: Optional[FRCRNConfig] = None,
        device="cpu") -> Tuple[FRCRN, FRCRNConfig]:
    """Bind a vendor FRCRN state dict (wrapper prefixes from
    ``VENDOR_PREFIXES`` stripped first); returns (model on ``device``,
    cfg), the cfg inferred from the tensors unless given."""
    sd = _strip_prefix(sd)
    cfg = cfg or config_from_state_dict(sd)
    return load_module(FRCRN(cfg), sd).to(device), cfg


def params_from_onnx(src, cfg: Optional[FRCRNConfig] = None, device="cpu"):
    """ONNX export (torch names kept as initializers) -> (model, cfg)."""
    from whisperjav_tpu_torch.utils.onnx_io import read_initializers

    return params_from_torch_state_dict(read_initializers(src), cfg, device)


# ---------------------------------------------------------------------------
# checkpoint IO
# ---------------------------------------------------------------------------

def save_params(path: str, model: FRCRN) -> None:
    """Write the JAX package's ``.npz`` layout (``a/0/w`` keys, the config
    under ``__meta__``)."""
    from whisperjav_tpu_torch.utils.pytree_npz import save_pytree

    save_pytree(path, tree_from_module(model),
                meta=dataclasses.asdict(model.cfg))


def _geom(g: Dict) -> StageGeom:
    return StageGeom(**{**g, "kernel": tuple(g["kernel"]),
                        "stride": tuple(g["stride"]),
                        "padding": tuple(g["padding"])})


def load_checkpoint(path: str, device="cpu") -> Tuple[FRCRN, FRCRNConfig]:
    """``.npz`` (the JAX package's layout) / ``.onnx`` / torch
    ``.pt|.pth|.ckpt|.bin``; returns (model on ``device``, cfg)."""
    p = str(path)
    if p.endswith(".npz"):
        from whisperjav_tpu_torch.utils.pytree_npz import load_pytree

        tree, meta = load_pytree(p)
        if meta is None:
            raise ValueError(f"{p}: missing config metadata")
        meta["encoders"] = tuple(_geom(g) for g in meta["encoders"])
        meta["decoders"] = tuple(_geom(g) for g in meta["decoders"])
        cfg = FRCRNConfig(**meta)
        return params_from_jax(tree, cfg, device), cfg
    if p.endswith(".onnx"):
        return params_from_onnx(p, device=device)
    obj = torch.load(p, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return params_from_torch_state_dict(sd, device=device)
