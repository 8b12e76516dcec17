"""Qwen3-ASR weights drawn from ``--seed`` on the device, in the type
they are served in.

The benchmark's own draw, so that what decides ``correct`` does not
move with the port's init. Matrices N(0, 1/d) of their input width d
(the head's d_model), the token embedding N(0, 1/d_model), convolution
kernels with deviation 0.1; every bias and LayerNorm offset
0.02 N(0, 1) and every norm scale 1 + 0.1 N(0, 1), so that a bias or a
scale dropped, misplaced or swapped (q's norm for k's) changes the
result. The leaves keep the
port's names and layouts (``models/qwen/model.py:QwenASR``: (in, out)
matrices, OIHW convolutions, per-layer leaves stacked on a leading
axis), so the tree loads into the port's ``QwenASR`` as it is and the
reference reads the same tree. Each leaf is one ``randn`` call of a
generator on the device, in the order :func:`shapes` lists them.
"""

from __future__ import annotations

from typing import Dict

import torch

BIAS = 0.02
SCALE = 0.1
CONV = 0.1


def _freq_out(n_mels: int) -> int:
    """Frequency bins left after the tower's three stride-2 convolutions
    padded by one."""
    for _ in range(3):
        n_mels = (n_mels + 1) // 2
    return n_mels


def shapes(model: dict) -> Dict:
    """Each leaf's shape, as a nested dict in drawing order."""
    L, d = model["n_layers"], model["d_model"]
    hd = model["lm_head_dim"] or d // model["n_heads"]
    qd, kvd = model["n_heads"] * hd, model["n_kv_heads"] * hd
    ff, vocab = model["d_ff"], model["vocab_size"]
    da, La = model["d_audio"], model["audio_layers"]
    h, fa = model["audio_downsample_hidden"], model["audio_ffn"]
    return {
        "audio": {
            "conv2d1_w": (h, 1, 3, 3), "conv2d1_b": (h,),
            "conv2d2_w": (h, h, 3, 3), "conv2d2_b": (h,),
            "conv2d3_w": (h, h, 3, 3), "conv2d3_b": (h,),
            "conv_out_w": (h * _freq_out(model["n_mels"]), da),
            "blocks": {
                "ln1_s": (La, da), "ln1_b": (La, da),
                "wq": (La, da, da), "bq": (La, da),
                "wk": (La, da, da), "bk": (La, da),
                "wv": (La, da, da), "bv": (La, da),
                "wo": (La, da, da), "bo": (La, da),
                "ln2_s": (La, da), "ln2_b": (La, da),
                "w1": (La, da, fa), "b1": (La, fa),
                "w2": (La, fa, da), "b2": (La, da),
            },
            "ln_post_s": (da,), "ln_post_b": (da,),
            "proj1_w": (da, da), "proj1_b": (da,),
            "proj2_w": (da, d), "proj2_b": (d,),
        },
        "tok_emb": (vocab, d),
        "blocks": {
            "ln1": (L, d),
            "wq": (L, d, qd), "wk": (L, d, kvd), "wv": (L, d, kvd),
            "wo": (L, qd, d),
            "q_norm": (L, hd), "k_norm": (L, hd),
            "ln2": (L, d),
            "w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d),
        },
        "ln_f": (d,),
        "lm_head": (d, vocab),
    }


def _is_scale(name: str) -> bool:
    return name in ("ln1", "ln2", "ln_f", "q_norm", "k_norm") \
        or (name.startswith("ln") and name.endswith("_s"))


def draw(model: dict, seed: int, device, dtype=torch.float32) -> Dict:
    """The weight tree of ``model`` (a configuration file's ``model``
    sizes) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(name, shape):
        x = torch.randn(shape, generator=gen, device=device)
        if _is_scale(name):
            x.mul_(SCALE).add_(1.0)
        elif name.startswith("conv2d") and name.endswith("_w"):
            x.mul_(CONV)
        elif name.startswith("w") or name.endswith("_w") \
                or name in ("tok_emb", "lm_head"):
            x.mul_(shape[-2] ** -0.5 if name != "tok_emb"
                   else shape[-1] ** -0.5)
        else:
            x.mul_(BIAS)
        return x.to(dtype)

    def part(tree):
        return {k: part(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    return part(shapes(model))
