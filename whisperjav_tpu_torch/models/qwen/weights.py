"""Qwen3-ASR weights for the port: from a JAX tree or random.

The JAX package keeps the parameters as a nested dict with per-layer
leaves stacked on a leading axis and matrices as (in, out)
(``whisperjav_tpu/models/qwen/model.py:202-279``); :class:`QwenASR`
keeps the same names and layouts, so conversion is a copy per leaf. A
quantised tree's ``{"q": int8, "s": f32}`` leaves (``quantize_lm_weights``)
become :class:`Int8Weight` modules (state-dict names ``<leaf>.q`` /
``<leaf>.s``). The forced aligner's tree carries across with
``models/qwen/aligner.py:params_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from whisperjav_tpu_torch.models.layers import tree_to_torch
from whisperjav_tpu_torch.models.qwen.model import QwenASR, QwenASRConfig


def params_from_jax(tree: Dict, cfg: QwenASRConfig,
                    dtype: Optional[torch.dtype] = None,
                    device="cpu") -> QwenASR:
    """A JAX Qwen3-ASR tree (f32, bf16 or int8-dict leaves) ->
    :class:`QwenASR`; both packages then compute from the same
    numbers."""
    return QwenASR(cfg, tree_to_torch(tree, dtype, device))


def init_params(cfg: QwenASRConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cpu", audio: bool = True) -> QwenASR:
    """Random weights with the JAX init's shapes and scales: LM matrices,
    token embedding and lm head N(0, 1/d_model), audio-tower matrices
    N(0, 1/d_audio), convolution kernels N(0, 0.01), norm scales one,
    biases zero. Drawn from ``generator``, which must live on
    ``device``, where every leaf is made. ``audio=False`` leaves the
    audio tower out: the LM-only tree ``convert.load_lm`` gives, with the
    embedding and the head as separate arrays."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    s = d ** -0.5
    blocks = {
        "ln1": ones(L, d),
        "wq": normal((L, d, qd), s), "wk": normal((L, d, kvd), s),
        "wv": normal((L, d, kvd), s), "wo": normal((L, qd, d), s),
        "q_norm": ones(L, hd), "k_norm": ones(L, hd),
        "ln2": ones(L, d),
        "w_gate": normal((L, d, cfg.d_ff), s),
        "w_up": normal((L, d, cfg.d_ff), s),
        "w_down": normal((L, cfg.d_ff, d), s),
    }
    lm = {"blocks": blocks}
    if not audio:
        return QwenASR(cfg, {"tok_emb": normal((cfg.vocab_size, d), s),
                             **lm, "ln_f": ones(d),
                             "lm_head": normal((d, cfg.vocab_size), s)})
    da, h, La = cfg.d_audio, cfg.audio_downsample_hidden, cfg.audio_layers
    sa = da ** -0.5
    freq_out = cfg.n_mels
    for _ in range(3):
        freq_out = (freq_out + 1) // 2
    audio = {
        "conv2d1_w": normal((h, 1, 3, 3), 0.1), "conv2d1_b": zeros(h),
        "conv2d2_w": normal((h, h, 3, 3), 0.1), "conv2d2_b": zeros(h),
        "conv2d3_w": normal((h, h, 3, 3), 0.1), "conv2d3_b": zeros(h),
        "conv_out_w": normal((h * freq_out, da), sa),
        "blocks": {
            "ln1_s": ones(La, da), "ln1_b": zeros(La, da),
            "wq": normal((La, da, da), sa), "bq": zeros(La, da),
            "wk": normal((La, da, da), sa), "bk": zeros(La, da),
            "wv": normal((La, da, da), sa), "bv": zeros(La, da),
            "wo": normal((La, da, da), sa), "bo": zeros(La, da),
            "ln2_s": ones(La, da), "ln2_b": zeros(La, da),
            "w1": normal((La, da, cfg.audio_ffn), sa),
            "b1": zeros(La, cfg.audio_ffn),
            "w2": normal((La, cfg.audio_ffn, da), sa), "b2": zeros(La, da),
        },
        "ln_post_s": ones(da), "ln_post_b": zeros(da),
        "proj1_w": normal((da, da), sa), "proj1_b": zeros(da),
        "proj2_w": normal((da, d), sa), "proj2_b": zeros(d),
    }
    return QwenASR(cfg, {
        "audio": audio,
        "tok_emb": normal((cfg.vocab_size, d), s),
        "blocks": blocks,
        "ln_f": ones(d),
        "lm_head": normal((d, cfg.vocab_size), s),
    })
