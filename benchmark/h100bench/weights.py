"""Whisper weights drawn from ``--seed`` on the device, in the type they
are served in.

The init scheme is the one the port and the JAX package share
(``whisperjav_tpu_torch/models/whisper/weights.py:init_params``),
copied: matrices N(0, 1/d), LayerNorm scales one, biases zero,
sinusoid encoder positions, zero decoder positions; with one departure:
the decoder's cross-attention query and key projections are drawn
twice as wide (``GAINS``). Under the plain scheme a query's logits over
the encoder frames spread by about one, so cross-attention is near
uniform over 448-1500 frames and averages away whatever the cross-K/V's
precision changes; trained Whisper attends to a few frames, and so do
these weights (the logits spread by four). The leaves keep the
port's names and (in, out) stacked layouts, so the tree loads into the
port's ``Whisper`` as it is, and the reference reads the same tree. Each
leaf is one ``randn`` call of a generator on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# how much wider than N(0, 1/d) the cross-attention projections are drawn
GAINS = {"cwq": 2.0, "cwk": 2.0}


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


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


def draw(model: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of ``model`` (a configuration file's ``model``
    sizes) from ``seed``."""
    d = model["d_model"]
    s = d ** -0.5
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(name, shape):
        if name.startswith("ln") and name.endswith("_s"):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.startswith(("w", "cw", "tok")) or name.endswith("_w"):
            x = torch.randn(shape, generator=gen, device=device)
            return x.mul_(s * GAINS.get(name, 1.0)).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)

    def part(shapes):
        return {name: leaf(name, shape) for name, shape in shapes.items()}

    encoder = part({"conv1_w": (d, model["n_mels"], 3), "conv1_b": (d,),
                    "conv2_w": (d, d, 3), "conv2_b": (d,),
                    "ln_s": (d,), "ln_b": (d,)})
    encoder["pos"] = torch.from_numpy(sinusoid_positions(
        model["n_audio_ctx"], d)).to(device=device, dtype=dtype)
    encoder["blocks"] = part(_block_shapes(model["encoder_layers"], d,
                                           cross=False))
    decoder = part({"tok_emb": (model["vocab_size"], d),
                    "pos_emb": (model["n_text_ctx"], d),
                    "ln_s": (d,), "ln_b": (d,)})
    decoder["blocks"] = part(_block_shapes(model["decoder_layers"], d,
                                           cross=True))
    return {"encoder": encoder, "decoder": decoder}
