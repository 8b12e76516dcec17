"""The building blocks the Whisper and Qwen3-ASR models share.

- The int8 weight format, the one data format both model families know:
  :class:`Int8` (codes and scales of one layer), :class:`Int8Weight`
  (the JAX tree's ``{"q": int8, "s": f32}`` leaf as a module),
  :func:`quantize` (the JAX package's eager quantiser) and
  :func:`int8_matmul` (the product both families take of it).
- The parameter tree: :func:`is_int8`, :func:`tree_to_torch` (a JAX tree
  of arrays to one of tensors) and :class:`ParamTree` (such a tree as a
  module, which keeps the JAX tree's names as state-dict names).
- :func:`layer_norm`, :func:`sinusoid_positions` and
  :func:`draw_gumbel`, the sampled decoders' noise.

Each family keeps its own ``dense``: Whisper's float product takes the
bias inside the f32 accumulation (``addmm``), Qwen's rounds the product
before the bias, and each gives the JAX package's own numbers.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, result in x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       bias.float(), eps)
    return out.to(x.dtype)


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions (also the AuT
    tower's, reset at every chunk)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def draw_gumbel(generator: torch.Generator, shape,
                device) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

class Int8(NamedTuple):
    """One int8 weight: codes (in, out) and f32 scales (1, out)."""
    q: torch.Tensor
    s: torch.Tensor


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) -> (int8 codes, f32 scales (..., 1, out)): scale =
    max |w| over the input axis / 127 + 1e-12, codes rounded half to even
    (as ``jnp.round``) and clipped to +-127. The divisor is a tensor on
    w's device: CUDA divides by a host scalar as a product with its
    reciprocal, which can round one ulp apart from the division."""
    w32 = w.float()
    s = w32.abs().amax(dim=-2, keepdim=True) / w32.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q.contiguous(), s


def int8_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., in) times an int8 weight (``.q`` (in, out) codes, ``.s``
    (1, out) scales), in f32: the product of x and the codes (a product
    in x's dtype would round first), then the scale, as the JAX package's
    int8 ``dense`` and int8 heads."""
    return torch.matmul(x.float(), w.q.float()) * w.s.float()


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(x), requires_grad=False)


class Int8Weight(nn.Module):
    """A ``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}`` leaf of the
    JAX tree: symmetric int8 codes with per-output-channel scales, as
    parameters ``q`` and ``s`` (state-dict names ``<leaf>.q``,
    ``<leaf>.s``). ``w[i]`` is layer i of a stacked one, as an
    :class:`Int8` of views. Casting the module casts ``s``: quantise
    after the cast to the compute dtype, as the engine does."""

    def __init__(self, q, s):
        super().__init__()
        self.q = _param(q)
        self.s = _param(s)

    def __getitem__(self, i: int) -> Int8:
        return Int8(self.q[i], self.s[i])


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def is_int8(tree) -> bool:
    """A quantised leaf of the JAX tree: ``{"q": codes, "s": scales}``."""
    return isinstance(tree, dict) and set(tree) == {"q", "s"}


def tree_to_torch(tree, dtype: Optional[torch.dtype] = None, device="cpu"):
    """A JAX parameter tree (array or numpy leaves, ml_dtypes bf16
    included) -> the same tree of tensors on ``device``; ``dtype`` casts
    floating leaves (None keeps each leaf's own); int8 leaves keep int8
    codes and f32 scales."""
    def tensor(x):
        x = np.array(x, copy=True)
        if x.dtype.name == "bfloat16":       # ml_dtypes' bf16: its bits
            return torch.from_numpy(x.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(x).to(device)

    if is_int8(tree):
        return {"q": tensor(tree["q"]), "s": tensor(tree["s"])}
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, dtype, device) for k, v in tree.items()}
    t = tensor(tree)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


class ParamTree(nn.Module):
    """One level of a JAX parameter tree: tensors as parameters, nested
    dicts as child trees, ``{"q", "s"}`` leaves as :class:`Int8Weight`.
    Indexed by name like the dict it came from; its state-dict names are
    the tree's paths (tensors of a level before its child trees)."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            self[name] = value

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, (nn.Module, nn.Parameter)):
            setattr(self, name, value)
        elif is_int8(value):
            setattr(self, name, Int8Weight(value["q"], value["s"]))
        elif isinstance(value, dict):
            setattr(self, name, ParamTree(value))
        else:
            setattr(self, name, _param(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def keys(self):
        return [*self._parameters, *self._modules]

    def pop(self, name: str):
        value = getattr(self, name)
        delattr(self, name)
        return value
