"""Checkpoint conversion: HF WhisperForConditionalGeneration → stacked pytree.

Loads torch/safetensors weights (from a local path or the HF cache) and
re-lays them into the scan-stacked parameter tree of
:mod:`whisperjav_tpu_torch.models.whisper.model`. Torch ``Linear.weight`` is
(out, in) and is transposed to our (in, out) layout; per-layer tensors are
stacked on a new leading axis.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig, WHISPER_SIZES


def config_from_hf(hf_config) -> WhisperConfig:
    """Map a transformers.WhisperConfig to our WhisperConfig."""
    return WhisperConfig(
        name=getattr(hf_config, "name_or_path", "hf") or "hf",
        n_mels=hf_config.num_mel_bins,
        n_audio_ctx=hf_config.max_source_positions,
        n_audio_state=hf_config.d_model,
        n_audio_head=hf_config.encoder_attention_heads,
        n_audio_layer=hf_config.encoder_layers,
        n_vocab=hf_config.vocab_size,
        n_text_ctx=hf_config.max_target_positions,
        n_text_state=hf_config.d_model,
        n_text_head=hf_config.decoder_attention_heads,
        n_text_layer=hf_config.decoder_layers,
    )


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _stack_blocks(sd: Mapping[str, Any], prefix: str, n_layer: int,
                  cross: bool, dtype) -> Dict[str, np.ndarray]:
    def get(i, name, transpose=False):
        arr = _np(sd[f"{prefix}.layers.{i}.{name}"])
        return arr.T if transpose else arr

    def stack(name, transpose=False):
        return np.stack([get(i, name, transpose) for i in range(n_layer)]
                        ).astype(dtype)

    p = {
        "ln1_s": stack("self_attn_layer_norm.weight"),
        "ln1_b": stack("self_attn_layer_norm.bias"),
        "wq": stack("self_attn.q_proj.weight", True),
        "bq": stack("self_attn.q_proj.bias"),
        "wk": stack("self_attn.k_proj.weight", True),
        "wv": stack("self_attn.v_proj.weight", True),
        "bv": stack("self_attn.v_proj.bias"),
        "wo": stack("self_attn.out_proj.weight", True),
        "bo": stack("self_attn.out_proj.bias"),
        "ln2_s": stack("final_layer_norm.weight"),
        "ln2_b": stack("final_layer_norm.bias"),
        "w1": stack("fc1.weight", True),
        "b1": stack("fc1.bias"),
        "w2": stack("fc2.weight", True),
        "b2": stack("fc2.bias"),
    }
    if cross:
        p.update({
            "lnx_s": stack("encoder_attn_layer_norm.weight"),
            "lnx_b": stack("encoder_attn_layer_norm.bias"),
            "cwq": stack("encoder_attn.q_proj.weight", True),
            "cbq": stack("encoder_attn.q_proj.bias"),
            "cwk": stack("encoder_attn.k_proj.weight", True),
            "cwv": stack("encoder_attn.v_proj.weight", True),
            "cbv": stack("encoder_attn.v_proj.bias"),
            "cwo": stack("encoder_attn.out_proj.weight", True),
            "cbo": stack("encoder_attn.out_proj.bias"),
        })
    return p


def params_from_hf_state_dict(
    sd: Mapping[str, Any], config: WhisperConfig, dtype=np.float32,
) -> Dict[str, Any]:
    """Convert an HF Whisper state dict (model.* keys) to our param tree."""
    # accept both "model.encoder..." and "encoder..." key styles
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return {
        "encoder": {
            "conv1_w": _np(sd["encoder.conv1.weight"]).astype(dtype),
            "conv1_b": _np(sd["encoder.conv1.bias"]).astype(dtype),
            "conv2_w": _np(sd["encoder.conv2.weight"]).astype(dtype),
            "conv2_b": _np(sd["encoder.conv2.bias"]).astype(dtype),
            "pos": _np(sd["encoder.embed_positions.weight"]).astype(dtype),
            "blocks": _stack_blocks(sd, "encoder", config.n_audio_layer,
                                    False, dtype),
            "ln_s": _np(sd["encoder.layer_norm.weight"]).astype(dtype),
            "ln_b": _np(sd["encoder.layer_norm.bias"]).astype(dtype),
        },
        "decoder": {
            "tok_emb": _np(sd["decoder.embed_tokens.weight"]).astype(dtype),
            "pos_emb": _np(sd["decoder.embed_positions.weight"]).astype(dtype),
            "blocks": _stack_blocks(sd, "decoder", config.n_text_layer,
                                    True, dtype),
            "ln_s": _np(sd["decoder.layer_norm.weight"]).astype(dtype),
            "ln_b": _np(sd["decoder.layer_norm.bias"]).astype(dtype),
        },
    }


def load_pretrained(model_name_or_path: str, dtype=np.float32):
    """Load a Whisper checkpoint via transformers (local path or HF cache).

    Returns (config, params). Requires the checkpoint to be available
    locally — there is no network egress in the build environment.
    """
    import dataclasses

    import transformers

    hf = transformers.WhisperForConditionalGeneration.from_pretrained(
        model_name_or_path)
    config = config_from_hf(hf.config)
    # per-model word-alignment heads: checkpoint generation_config first
    # (the data openai-whisper encodes as _ALIGNMENT_HEADS blobs), then a
    # checkpoint-local alignment_heads.json, then the bundled table —
    # word_align.py uses them instead of the top-half-layers fallback
    from whisperjav_tpu_torch.models.whisper.alignment_heads import (
        resolve_alignment_heads,
    )
    ckpt_dir = (model_name_or_path
                if os.path.isdir(str(model_name_or_path)) else None)
    heads = resolve_alignment_heads(
        config.name, config.n_text_layer, config.n_text_head,
        generation_config_heads=getattr(
            hf.generation_config, "alignment_heads", None),
        checkpoint_dir=ckpt_dir)
    if heads:
        config = dataclasses.replace(config, alignment_heads=heads)
    params = params_from_hf_state_dict(hf.model.state_dict(), config, dtype)
    return config, params
