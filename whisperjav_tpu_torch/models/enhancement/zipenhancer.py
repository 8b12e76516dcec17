"""ZipEnhancer-family speech denoiser (MP-SENet design) in PyTorch.

Counterpart of ``whisperjav_tpu/models/enhancement/zipenhancer.py``:
(mag, pha) stacked -> DenseEncoder (1x1 conv -> dilated dense block over
time -> stride-(1, 2) frequency downsample) -> N dual-path blocks
(self-attention + FFN along time per frequency, then along frequency per
frame) -> MaskDecoder (dense block -> ConvTranspose up -> learnable
per-frequency sigmoid; enhanced magnitude = noisy magnitude x mask) and
PhaseDecoder (dense block -> up -> real/imag heads -> atan2).

:class:`ZipEnhancerNet` holds its parameters under the canonical torch
names the JAX package's ``params_from_torch_state_dict`` documents
(``dense_encoder.conv1``, ``blocks.{n}.time.attn.in_proj_weight``,
``mask_decoder.beta``, ...), so a torch checkpoint loads with
``load_state_dict``; :func:`params_from_jax`, :func:`save_params` and
:func:`load_params` read and write the JAX package's parameter tree and
its ``.npz`` layout (``__cfg__`` record included), so a file either
package writes loads in the other.

The forward pass is plain PyTorch in f32, as the JAX package computes
it: the module states its own precision (no TF32 in convolutions or
matmuls, whatever the process-wide flags say). The time path's
attention holds (N, H, T, T) f32 logits; it runs over pieces of N whose
logits take at most ``ATTN_PIECE_BYTES`` (the results are the same).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.ops.stft import istft, stft
from whisperjav_tpu_torch.utils.precision import full_f32

N_FFT = 400
HOP = 100
COMPRESS = 0.3
N_FREQS = N_FFT // 2 + 1   # 201
# the largest f32 logits block of one attention piece
ATTN_PIECE_BYTES = 1 << 30


@dataclass(frozen=True)
class ZipConfig:
    width: int = 64          # channel width C
    n_blocks: int = 4        # dual-path blocks
    n_heads: int = 4
    ffn_mult: int = 4
    dense_depth: int = 4     # dilated dense block layers (dilations 2**i)
    n_freqs: int = N_FREQS

    @property
    def down_freqs(self) -> int:
        # stride-(1,2) conv, kernel (1,3), pad (0,1)
        return (self.n_freqs + 2 - 3) // 2 + 1


ZIP_TEST = ZipConfig(width=8, n_blocks=1, n_heads=2, ffn_mult=2,
                     dense_depth=2)
ZIP_BASE = ZipConfig()


# ---------------------------------------------------------------------------
# STFT interface (modelscope mag_pha_stft / istft semantics)
# ---------------------------------------------------------------------------

def mag_pha_stft(audio: torch.Tensor, compress_factor: float = COMPRESS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (B, T) -> (mag**cf, pha), each (B, F, frames)."""
    r, i = stft(audio, N_FFT, HOP)
    mag = torch.sqrt(r * r + i * i + 1e-9)
    pha = torch.atan2(i, r)
    return torch.pow(mag, compress_factor), pha


def mag_pha_istft(mag: torch.Tensor, pha: torch.Tensor, length: int,
                  compress_factor: float = COMPRESS) -> torch.Tensor:
    """Inverse: decompress magnitude, recombine with phase, ISTFT."""
    mag = torch.pow(mag, 1.0 / compress_factor)
    return istft(mag * torch.cos(pha), mag * torch.sin(pha), length,
                 N_FFT, HOP)


# ---------------------------------------------------------------------------
# modules (parameter containers under the canonical names)
# ---------------------------------------------------------------------------

class _DenseLayer(nn.Module):
    def __init__(self, c: int, i: int):
        super().__init__()
        self.conv = nn.Conv2d(c * (i + 1), c, 3, padding=(2 ** i, 1),
                              dilation=(2 ** i, 1))
        self.norm = nn.InstanceNorm2d(c, affine=True)
        self.prelu = nn.PReLU(c)


class _DenseBlock(nn.ModuleList):
    """Dilated dense block: layer i sees all previous features, dilation
    2**i along the time axis."""

    def __init__(self, cfg: ZipConfig):
        super().__init__([_DenseLayer(cfg.width, i)
                          for i in range(cfg.dense_depth)])

    def forward(self, x):
        feats = x
        for layer in self:
            h = _norm_act(layer.conv(feats), layer.norm, layer.prelu)
            feats = torch.cat([feats, h], dim=1)
            x = h
        return x


def _norm_act(x, norm: nn.InstanceNorm2d, prelu: nn.PReLU):
    """InstanceNorm2d (affine, biased variance) then per-channel PReLU."""
    x = F.instance_norm(x, weight=norm.weight, bias=norm.bias, eps=1e-5)
    return F.prelu(x, prelu.weight)


class _DPSub(nn.Module):
    """Pre-LN attention + FFN over the middle axis of (N, T, d)."""

    def __init__(self, cfg: ZipConfig):
        super().__init__()
        d = cfg.width
        self.n_heads = cfg.n_heads
        self.ln1 = nn.LayerNorm(d)
        self.attn = nn.MultiheadAttention(d, cfg.n_heads, batch_first=True)
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, d * cfg.ffn_mult)
        self.fc2 = nn.Linear(d * cfg.ffn_mult, d)

    def _mhsa(self, x):
        """Bidirectional self-attention as torch MHA computes it: the
        q/k/v projections, f32 logits of q * hd^-0.5 against k, softmax,
        the product with v, the output projection."""
        n, t, d = x.shape
        h = self.n_heads
        hd = d // h
        qkv = F.linear(x, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(n, t, h, hd)
                   .transpose(1, 2) for i in range(3))       # (N, H, T, hd)
        q = q * hd ** -0.5
        piece = max(1, ATTN_PIECE_BYTES // (h * t * t * 4))
        o = torch.empty_like(q)
        for a in range(0, n, piece):
            w = torch.softmax(torch.matmul(q[a:a + piece],
                                           k[a:a + piece].transpose(-1, -2)),
                              dim=-1)
            o[a:a + piece] = torch.matmul(w, v[a:a + piece])
            del w
        o = o.transpose(1, 2).reshape(n, t, d)
        return F.linear(o, self.attn.out_proj.weight, self.attn.out_proj.bias)

    def forward(self, x):
        d = x.shape[-1]
        h = F.layer_norm(x, (d,), self.ln1.weight, self.ln1.bias, 1e-5)
        x = x + self._mhsa(h)
        h = F.layer_norm(x, (d,), self.ln2.weight, self.ln2.bias, 1e-5)
        h = F.gelu(F.linear(h, self.fc1.weight, self.fc1.bias))
        return x + F.linear(h, self.fc2.weight, self.fc2.bias)


class _Block(nn.Module):
    def __init__(self, cfg: ZipConfig):
        super().__init__()
        self.time = _DPSub(cfg)
        self.freq = _DPSub(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: ZipConfig):
        super().__init__()
        c = cfg.width
        self.conv1 = nn.Conv2d(2, c, 1)
        self.norm1 = nn.InstanceNorm2d(c, affine=True)
        self.prelu1 = nn.PReLU(c)
        self.dense = _DenseBlock(cfg)
        self.conv2 = nn.Conv2d(c, c, (1, 3), stride=(1, 2), padding=(0, 1))
        self.norm2 = nn.InstanceNorm2d(c, affine=True)
        self.prelu2 = nn.PReLU(c)

    def forward(self, x):
        x = _norm_act(self.conv1(x), self.norm1, self.prelu1)
        x = self.dense(x)
        return _norm_act(self.conv2(x), self.norm2, self.prelu2)


class _MaskDecoder(nn.Module):
    def __init__(self, cfg: ZipConfig):
        super().__init__()
        c = cfg.width
        self.dense = _DenseBlock(cfg)
        # kernel (1, 3), stride (1, 2), pad (0, 1): F' -> 2F' - 1
        self.up = nn.ConvTranspose2d(c, c, (1, 3), stride=(1, 2),
                                     padding=(0, 1))
        self.conv = nn.Conv2d(c, 1, 1)
        self.beta = nn.Parameter(torch.full((cfg.n_freqs,), 2.0))


class _PhaseDecoder(nn.Module):
    def __init__(self, cfg: ZipConfig):
        super().__init__()
        c = cfg.width
        self.dense = _DenseBlock(cfg)
        self.up = nn.ConvTranspose2d(c, c, (1, 3), stride=(1, 2),
                                     padding=(0, 1))
        self.conv_r = nn.Conv2d(c, 1, 1)
        self.conv_i = nn.Conv2d(c, 1, 1)


class ZipEnhancerNet(nn.Module):
    """The dual-path generator. ``forward(mag, pha)``: compressed-domain
    (B, F, T) spectrogram inputs -> enhanced (mag, pha), the ONNX
    contract's frequency-major layout."""

    def __init__(self, cfg: ZipConfig = ZIP_BASE):
        super().__init__()
        self.cfg = cfg
        self.dense_encoder = _Encoder(cfg)
        self.blocks = nn.ModuleList([_Block(cfg)
                                     for _ in range(cfg.n_blocks)])
        self.mask_decoder = _MaskDecoder(cfg)
        self.phase_decoder = _PhaseDecoder(cfg)
        self.requires_grad_(False)

    def forward(self, mag: torch.Tensor, pha: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, _, t = mag.shape
        x = torch.stack([mag, pha], dim=1).transpose(2, 3)   # (B, 2, T, F)
        x = self.dense_encoder(x)
        c, fd = self.cfg.width, x.shape[-1]
        for blk in self.blocks:
            # time path: (B*F', T, C)
            h = blk.time(x.permute(0, 3, 2, 1).reshape(b * fd, t, c))
            x = h.reshape(b, fd, t, c).permute(0, 3, 2, 1)
            # frequency path: (B*T, F', C)
            h = blk.freq(x.permute(0, 2, 3, 1).reshape(b * t, fd, c))
            x = h.reshape(b, t, fd, c).permute(0, 3, 1, 2)

        md = self.mask_decoder
        m = md.conv(md.up(md.dense(x)))[:, 0].transpose(1, 2)  # (B, F, T)
        mask = 1.2 / (1.0 + torch.exp(-md.beta[None, :, None] * m))
        mag_out = mag * mask

        pd = self.phase_decoder
        ph = pd.up(pd.dense(x))
        r = pd.conv_r(ph)[:, 0]
        i = pd.conv_i(ph)[:, 0]
        pha_out = torch.atan2(i, r).transpose(1, 2)
        return mag_out, pha_out


def forward(model: ZipEnhancerNet, mag: torch.Tensor, pha: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generator in full f32, without autograd."""
    with torch.inference_mode(), full_f32():
        return model(mag.float(), pha.float())


def denoise(model: ZipEnhancerNet, audio: torch.Tensor,
            length: int) -> torch.Tensor:
    """audio (B, length) -> denoised (B, length), f32, on audio's device.

    Includes the modelscope pre/post math: per-clip RMS norm factor,
    compressed-domain enhancement, ISTFT, denorm."""
    with torch.inference_mode(), full_f32():
        audio = audio[:, :length].float()
        norm = torch.sqrt(length / (torch.sum(audio ** 2, dim=1,
                                              keepdim=True) + 1e-9))
        x = audio * norm
        mag, pha = mag_pha_stft(x)
        mag_g, pha_g = model(mag, pha)
        wav = mag_pha_istft(mag_g, pha_g, length)
        return wav / norm


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ZipConfig = ZIP_BASE,
                generator: Optional[torch.Generator] = None,
                device="cpu") -> ZipEnhancerNet:
    """Random weights with the JAX package's init distribution: He-normal
    convolutions and FFN matrices (std sqrt(2 / fan_in)), attention
    matrices N(0, 1/d), zero biases, unit norms, PReLU slopes 0.25, mask
    betas 2.0. Drawn on the CPU from ``generator``; returned on
    ``device``."""
    model = ZipEnhancerNet(cfg)
    d = cfg.width

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("attn.in_proj_weight") \
                    or name.endswith("attn.out_proj.weight"):
                normal(p, d ** -0.5)
            elif leaf == "weight" and ".prelu" in name:
                p.fill_(0.25)
            elif leaf == "weight" and (".norm" in name or ".ln" in name):
                p.fill_(1.0)
            elif leaf == "weight":
                # conv (O, I, kh, kw), conv-transpose (I, O, kh, kw) with
                # I = O, linear (out, in): fan_in is the product past dim 0
                normal(p, (2.0 / int(np.prod(p.shape[1:]))) ** 0.5)
            elif leaf == "beta":
                p.fill_(2.0)
            else:
                p.zero_()
    return model.to(device)


# ---------------------------------------------------------------------------
# the JAX package's parameter tree
# ---------------------------------------------------------------------------

def _dense_tree(sd: Mapping[str, Any], prefix: str, depth: int, g):
    return [{"w": g(f"{prefix}.{i}.conv.weight"),
             "b": g(f"{prefix}.{i}.conv.bias"),
             "in_s": g(f"{prefix}.{i}.norm.weight"),
             "in_b": g(f"{prefix}.{i}.norm.bias"),
             "pr": g(f"{prefix}.{i}.prelu.weight")} for i in range(depth)]


def tree_from_state_dict(sd: Mapping[str, Any], cfg: ZipConfig = ZIP_BASE,
                         dtype=np.float32) -> Dict:
    """A state dict under the canonical names -> the JAX package's tree
    (numpy leaves; matrices (in, out), attention split into q/k/v)."""
    def g(name):
        t = sd[name]
        if hasattr(t, "detach"):
            t = t.detach().cpu().numpy()
        return np.asarray(t).astype(dtype)

    def attn(prefix):
        d = cfg.width
        wqkv = g(f"{prefix}.in_proj_weight")          # (3d, d)
        bqkv = g(f"{prefix}.in_proj_bias")
        return {"wq": wqkv[:d].T, "wk": wqkv[d:2 * d].T, "wv": wqkv[2 * d:].T,
                "bq": bqkv[:d], "bk": bqkv[d:2 * d], "bv": bqkv[2 * d:],
                "wo": g(f"{prefix}.out_proj.weight").T,
                "bo": g(f"{prefix}.out_proj.bias")}

    def dp_sub(prefix):
        return {"ln1_s": g(f"{prefix}.ln1.weight"),
                "ln1_b": g(f"{prefix}.ln1.bias"),
                "attn": attn(f"{prefix}.attn"),
                "ln2_s": g(f"{prefix}.ln2.weight"),
                "ln2_b": g(f"{prefix}.ln2.bias"),
                "w1": g(f"{prefix}.fc1.weight").T,
                "b1": g(f"{prefix}.fc1.bias"),
                "w2": g(f"{prefix}.fc2.weight").T,
                "b2": g(f"{prefix}.fc2.bias")}

    n_blocks = 0
    while f"blocks.{n_blocks}.time.ln1.weight" in sd:
        n_blocks += 1
    depth = cfg.dense_depth
    return {
        "enc_conv1_w": g("dense_encoder.conv1.weight"),
        "enc_conv1_b": g("dense_encoder.conv1.bias"),
        "enc_norm1_s": g("dense_encoder.norm1.weight"),
        "enc_norm1_b": g("dense_encoder.norm1.bias"),
        "enc_pr1": g("dense_encoder.prelu1.weight"),
        "enc_dense": _dense_tree(sd, "dense_encoder.dense", depth, g),
        "enc_conv2_w": g("dense_encoder.conv2.weight"),
        "enc_conv2_b": g("dense_encoder.conv2.bias"),
        "enc_norm2_s": g("dense_encoder.norm2.weight"),
        "enc_norm2_b": g("dense_encoder.norm2.bias"),
        "enc_pr2": g("dense_encoder.prelu2.weight"),
        "blocks": [{"time": dp_sub(f"blocks.{i}.time"),
                    "freq": dp_sub(f"blocks.{i}.freq")}
                   for i in range(n_blocks)],
        "mask_dense": _dense_tree(sd, "mask_decoder.dense", depth, g),
        "mask_up_w": g("mask_decoder.up.weight"),
        "mask_up_b": g("mask_decoder.up.bias"),
        "mask_conv_w": g("mask_decoder.conv.weight"),
        "mask_conv_b": g("mask_decoder.conv.bias"),
        "mask_beta": g("mask_decoder.beta"),
        "pha_dense": _dense_tree(sd, "phase_decoder.dense", depth, g),
        "pha_up_w": g("phase_decoder.up.weight"),
        "pha_up_b": g("phase_decoder.up.bias"),
        "pha_r_w": g("phase_decoder.conv_r.weight"),
        "pha_r_b": g("phase_decoder.conv_r.bias"),
        "pha_i_w": g("phase_decoder.conv_i.weight"),
        "pha_i_b": g("phase_decoder.conv_i.bias"),
    }


def state_dict_from_tree(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's tree (array or numpy leaves) -> a state dict
    under the canonical names; the inverse of
    :func:`tree_from_state_dict`."""
    def a(x):
        return np.asarray(x, np.float32)

    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, layers):
        for i, p in enumerate(layers):
            sd[f"{prefix}.{i}.conv.weight"] = a(p["w"])
            sd[f"{prefix}.{i}.conv.bias"] = a(p["b"])
            sd[f"{prefix}.{i}.norm.weight"] = a(p["in_s"])
            sd[f"{prefix}.{i}.norm.bias"] = a(p["in_b"])
            sd[f"{prefix}.{i}.prelu.weight"] = a(p["pr"])

    def dp_sub(prefix, p):
        at = p["attn"]
        sd[f"{prefix}.ln1.weight"] = a(p["ln1_s"])
        sd[f"{prefix}.ln1.bias"] = a(p["ln1_b"])
        sd[f"{prefix}.attn.in_proj_weight"] = np.concatenate(
            [a(at["wq"]).T, a(at["wk"]).T, a(at["wv"]).T], axis=0)
        sd[f"{prefix}.attn.in_proj_bias"] = np.concatenate(
            [a(at["bq"]), a(at["bk"]), a(at["bv"])])
        sd[f"{prefix}.attn.out_proj.weight"] = a(at["wo"]).T
        sd[f"{prefix}.attn.out_proj.bias"] = a(at["bo"])
        sd[f"{prefix}.ln2.weight"] = a(p["ln2_s"])
        sd[f"{prefix}.ln2.bias"] = a(p["ln2_b"])
        sd[f"{prefix}.fc1.weight"] = a(p["w1"]).T
        sd[f"{prefix}.fc1.bias"] = a(p["b1"])
        sd[f"{prefix}.fc2.weight"] = a(p["w2"]).T
        sd[f"{prefix}.fc2.bias"] = a(p["b2"])

    for part, name in (("conv1", "enc_conv1"), ("conv2", "enc_conv2")):
        sd[f"dense_encoder.{part}.weight"] = a(tree[f"{name}_w"])
        sd[f"dense_encoder.{part}.bias"] = a(tree[f"{name}_b"])
    for k in ("1", "2"):
        sd[f"dense_encoder.norm{k}.weight"] = a(tree[f"enc_norm{k}_s"])
        sd[f"dense_encoder.norm{k}.bias"] = a(tree[f"enc_norm{k}_b"])
        sd[f"dense_encoder.prelu{k}.weight"] = a(tree[f"enc_pr{k}"])
    dense("dense_encoder.dense", tree["enc_dense"])
    for i, blk in enumerate(tree["blocks"]):
        dp_sub(f"blocks.{i}.time", blk["time"])
        dp_sub(f"blocks.{i}.freq", blk["freq"])
    dense("mask_decoder.dense", tree["mask_dense"])
    dense("phase_decoder.dense", tree["pha_dense"])
    for torch_name, key in (
            ("mask_decoder.up.weight", "mask_up_w"),
            ("mask_decoder.up.bias", "mask_up_b"),
            ("mask_decoder.conv.weight", "mask_conv_w"),
            ("mask_decoder.conv.bias", "mask_conv_b"),
            ("mask_decoder.beta", "mask_beta"),
            ("phase_decoder.up.weight", "pha_up_w"),
            ("phase_decoder.up.bias", "pha_up_b"),
            ("phase_decoder.conv_r.weight", "pha_r_w"),
            ("phase_decoder.conv_r.bias", "pha_r_b"),
            ("phase_decoder.conv_i.weight", "pha_i_w"),
            ("phase_decoder.conv_i.bias", "pha_i_b")):
        sd[torch_name] = a(tree[key])
    return sd


def _module(sd: Mapping[str, Any], cfg: ZipConfig, device) -> ZipEnhancerNet:
    model = ZipEnhancerNet(cfg)
    model.load_state_dict({
        k: (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, np.float32))).float()
        for k, v in sd.items()})
    return model.to(device)


def params_from_jax(tree: Mapping[str, Any], cfg: ZipConfig = ZIP_BASE,
                    device="cpu") -> ZipEnhancerNet:
    """The JAX package's parameter tree -> :class:`ZipEnhancerNet` on
    ``device``."""
    return _module(state_dict_from_tree(tree), cfg, device)


#: Vendor prefixes seen on published generator state dicts (ModelScope
#: wraps the generator in a decorator module; ONNX exports keep the torch
#: names). ``params_from_vendor`` strips the first that matches.
VENDOR_PREFIXES = ("generator.", "model.generator.", "model.",
                   "denoise_net.", "module.")


def params_from_vendor(sd: Mapping[str, Any], cfg: ZipConfig = ZIP_BASE,
                       device="cpu") -> ZipEnhancerNet:
    """A vendor state dict (ModelScope torch ``.bin`` contents) ->
    :class:`ZipEnhancerNet`, stripping wrapper prefixes first (a state
    dict under the canonical names loads as it is)."""
    for pre in VENDOR_PREFIXES:
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}
            break
    return _module(sd, cfg, device)


def params_from_onnx(src, cfg: ZipConfig = ZIP_BASE,
                     device="cpu") -> ZipEnhancerNet:
    """An ONNX export (the published ``ZipEnhancer-se-16k-base-onnx``
    file): torch.onnx.export keeps the state-dict names as initializer
    names, so the file's initializers are the vendor state dict."""
    from whisperjav_tpu_torch.utils.onnx_io import read_initializers

    return params_from_vendor(read_initializers(src), cfg, device)


# ---------------------------------------------------------------------------
# npz round trip (the JAX package's layout)
# ---------------------------------------------------------------------------

def save_params(path: str, model: ZipEnhancerNet) -> None:
    """Write the JAX package's ``.npz`` layout: the tree flattened with
    ``/`` (list items by index) and the ``__cfg__`` record."""
    cfg = model.cfg
    flat: Dict[str, np.ndarray] = {"__cfg__": np.asarray(
        [cfg.width, cfg.n_blocks, cfg.n_heads, cfg.ffn_mult,
         cfg.dense_depth, cfg.n_freqs], np.int64)}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree_from_state_dict(model.state_dict(), cfg))
    np.savez(path, **flat)


def load_params(path: str, device="cpu") -> Tuple[ZipEnhancerNet, ZipConfig]:
    """Load (model on ``device``, cfg) from the JAX package's ``.npz``
    layout (cfg defaults to ZIP_BASE when the archive has no ``__cfg__``
    record)."""
    data = np.load(path)
    cfg = ZIP_BASE
    tree: Dict = {}
    for key in data.files:
        if key == "__cfg__":
            cfg = ZipConfig(*[int(x) for x in data[key]])
            continue
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [listify(n[str(i)]) for i in range(len(n))]
            return {k: listify(v) for k, v in n.items()}
        return n

    return params_from_jax(listify(tree), cfg, device), cfg
