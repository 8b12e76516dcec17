"""Whisper weights for the port: from a JAX tree, random, or a checkpoint.

The JAX package keeps its parameters as a nested dict with per-layer
leaves stacked on a leading axis and matrices as (in, out)
(``whisperjav_tpu/models/whisper/model.py:145-195``); :class:`Whisper`
keeps the same names and layouts, so conversion is a copy per leaf,
both ways (:func:`params_from_jax`, :func:`params_to_jax`). The
enhancement models' trees (the ZipEnhancer and the legacy U-Net) carry
across with the ``params_from_jax`` of their own modules under
``models/enhancement/``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from whisperjav_tpu_torch.models.layers import (
    sinusoid_positions, tree_to_torch,
)
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.model import Whisper


def params_from_jax(tree: Dict, config: WhisperConfig,
                    dtype: Optional[torch.dtype] = None,
                    device="cpu") -> Whisper:
    """A JAX parameter tree (array or numpy leaves) -> :class:`Whisper`.
    ``dtype`` casts floating leaves; None keeps each leaf's own. A
    quantised tree's ``{"q": int8, "s": f32}`` leaves (in ``blocks`` and
    ``decoder.lm_head_q``) become :class:`Int8Weight` modules with
    parameters ``q`` and ``s``, kept int8 and f32: both packages then
    decode from the same codes."""
    return Whisper(config, tree_to_torch(tree, dtype, device))


def nest(flat: Dict[str, object]) -> Dict:
    """State-dict names ("decoder.blocks.wq") -> the nested tree
    :class:`Whisper` takes and the JAX package keeps."""
    tree: Dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16, which numpy does not hold, as
    float32."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_to_jax(model: Whisper) -> Dict:
    """:class:`Whisper` -> the JAX parameter tree of numpy arrays, under
    the same keys and layouts (the inverse of :func:`params_from_jax`;
    int8 leaves come back as ``{"q", "s"}``, bfloat16 leaves as
    float32)."""
    return nest({name: to_numpy(t)
                 for name, t in model.state_dict().items()})


def _block_shapes(n_layer: int, d: int, cross: bool) -> Dict[str, tuple]:
    mlp = 4 * d
    shapes = {
        "ln1_s": (n_layer, d), "ln1_b": (n_layer, d),
        "wq": (n_layer, d, d), "bq": (n_layer, d),
        "wk": (n_layer, d, d),
        "wv": (n_layer, d, d), "bv": (n_layer, d),
        "wo": (n_layer, d, d), "bo": (n_layer, d),
        "ln2_s": (n_layer, d), "ln2_b": (n_layer, d),
        "w1": (n_layer, d, mlp), "b1": (n_layer, mlp),
        "w2": (n_layer, mlp, d), "b2": (n_layer, d),
    }
    if cross:
        shapes.update({
            "lnx_s": (n_layer, d), "lnx_b": (n_layer, d),
            "cwq": (n_layer, d, d), "cbq": (n_layer, d),
            "cwk": (n_layer, d, d),
            "cwv": (n_layer, d, d), "cbv": (n_layer, d),
            "cwo": (n_layer, d, d), "cbo": (n_layer, d),
        })
    return shapes


def init_params(config: WhisperConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cpu") -> Whisper:
    """Random weights with the JAX package's init distribution: matrices
    N(0, 1/d), LayerNorm scales one, biases zero, sinusoid encoder
    positions, zero decoder positions. Drawn from ``generator``, which
    must live on ``device``."""
    d = config.n_audio_state
    s = d ** -0.5

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * s).to(dtype)

    def block_stack(n_layer, cross):
        out = {}
        for name, shape in _block_shapes(n_layer, d, cross).items():
            if name.startswith("ln") and name.endswith("_s"):
                out[name] = torch.ones(shape, dtype=dtype, device=device)
            elif name.startswith(("w", "cw")):
                out[name] = normal(shape)
            else:
                out[name] = torch.zeros(shape, dtype=dtype, device=device)
        return out

    ones = lambda: torch.ones((d,), dtype=dtype, device=device)   # noqa: E731
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)  # noqa: E731
    tree = {
        "encoder": {
            "conv1_w": normal((d, config.n_mels, 3)), "conv1_b": zeros(),
            "conv2_w": normal((d, d, 3)), "conv2_b": zeros(),
            "pos": torch.from_numpy(sinusoid_positions(
                config.n_audio_ctx, d)).to(device=device, dtype=dtype),
            "blocks": block_stack(config.n_audio_layer, cross=False),
            "ln_s": ones(), "ln_b": zeros(),
        },
        "decoder": {
            "tok_emb": normal((config.n_vocab, d)),
            "pos_emb": torch.zeros((config.n_text_ctx, d), dtype=dtype,
                                   device=device),
            "blocks": block_stack(config.n_text_layer, cross=True),
            "ln_s": ones(), "ln_b": zeros(),
        },
    }
    return Whisper(config, tree)


def load_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                    device="cpu"):
    """Local Hugging Face Whisper checkpoint -> (config, :class:`Whisper`),
    through ``convert.load_pretrained`` (the port's copy of the JAX
    package's converter, numpy only)."""
    from whisperjav_tpu_torch.models.whisper.convert import load_pretrained
    config, tree = load_pretrained(path, dtype=np.float32)
    return config, params_from_jax(tree, config, dtype=dtype, device=device)
