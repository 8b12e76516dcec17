"""Checkpoint conversion: HF Qwen3-ASR (thinker) → stacked pytree.

The port's copy of ``whisperjav_tpu/models/qwen/convert.py`` (numpy
only): the tree it builds goes to :class:`QwenASR` through
``weights.params_from_jax``. Reading a checkpoint needs ``transformers``;
without it :func:`load_pretrained` and :func:`load_lm` raise.
:func:`load_lm` reads a text-only Qwen3 causal LM (an instruct
checkpoint for the local translation backend) into an LM-only tree.

Maps the published qwen-asr / Qwen3-Omni-style state dict (reference
binding: whisperjav/modules/qwen_asr.py:545,581-608 loads
Qwen3ASRModel.from_pretrained → .thinker HF module tree) onto the param
tree of :mod:`whisperjav_tpu.models.qwen.model`. Accepted key styles:

- ``thinker.model.layers.*`` / ``thinker.audio_tower.*`` /
  ``thinker.lm_head.weight`` (the ASR checkpoint);
- ``model.layers.*`` + ``audio_tower.*`` (thinker prefix stripped);
- a bare ``Qwen3ForCausalLM`` state dict (text model only — audio tower
  left random; useful for LM-only parity tests).

Torch ``Linear.weight`` is (out, in) → transposed to our (in, out);
per-layer tensors stack on a leading axis. ``lm_head`` falls back to the
tied ``embed_tokens`` when absent (Qwen3 ≤1.7B ties embeddings).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np

from whisperjav_tpu_torch.models.qwen.model import QwenASRConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def config_from_hf(hf_config) -> QwenASRConfig:
    """Map an HF Qwen3-ASR (thinker) or Qwen3 text config to ours."""
    text = getattr(hf_config, "text_config", hf_config)
    audio = getattr(hf_config, "audio_config", None)
    kw: Dict[str, Any] = dict(
        name=getattr(hf_config, "name_or_path", "hf") or "hf",
        vocab_size=text.vocab_size,
        d_model=text.hidden_size,
        n_layers=text.num_hidden_layers,
        n_heads=text.num_attention_heads,
        n_kv_heads=text.num_key_value_heads,
        d_ff=text.intermediate_size,
        lm_head_dim=getattr(text, "head_dim", 0) or 0,
        rope_theta=float(getattr(text, "rope_theta", 1_000_000.0)),
        rms_eps=float(getattr(text, "rms_norm_eps", 1e-6)),
        eos_id=int(getattr(text, "eos_token_id", 2) or 2),
        bos_id=int(getattr(text, "bos_token_id", 1) or 1),
    )
    if audio is not None:
        kw.update(
            n_mels=audio.num_mel_bins,
            d_audio=audio.d_model,
            audio_layers=audio.encoder_layers,
            audio_heads=audio.encoder_attention_heads,
            audio_ffn=audio.encoder_ffn_dim,
            audio_downsample_hidden=audio.downsample_hidden_size,
            n_window=audio.n_window,
            n_window_infer=audio.n_window_infer,
        )
    return QwenASRConfig(**kw)


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        if k.startswith("thinker."):
            k = k[len("thinker."):]
        out[k] = v
    return out


def _stack_lm_blocks(sd, cfg: QwenASRConfig, dtype) -> Dict[str, np.ndarray]:
    def get(i, name, transpose=False):
        arr = _np(sd[f"model.layers.{i}.{name}"])
        return arr.T if transpose else arr

    def stack(name, transpose=False):
        return np.stack([get(i, name, transpose)
                         for i in range(cfg.n_layers)]).astype(dtype)

    return {
        "ln1": stack("input_layernorm.weight"),
        "wq": stack("self_attn.q_proj.weight", True),
        "wk": stack("self_attn.k_proj.weight", True),
        "wv": stack("self_attn.v_proj.weight", True),
        "wo": stack("self_attn.o_proj.weight", True),
        "q_norm": stack("self_attn.q_norm.weight"),
        "k_norm": stack("self_attn.k_norm.weight"),
        "ln2": stack("post_attention_layernorm.weight"),
        "w_gate": stack("mlp.gate_proj.weight", True),
        "w_up": stack("mlp.up_proj.weight", True),
        "w_down": stack("mlp.down_proj.weight", True),
    }


def _stack_audio_blocks(sd, cfg: QwenASRConfig, dtype) -> Dict[str, np.ndarray]:
    def get(i, name, transpose=False):
        arr = _np(sd[f"audio_tower.layers.{i}.{name}"])
        return arr.T if transpose else arr

    def stack(name, transpose=False):
        return np.stack([get(i, name, transpose)
                         for i in range(cfg.audio_layers)]).astype(dtype)

    return {
        "ln1_s": stack("self_attn_layer_norm.weight"),
        "ln1_b": stack("self_attn_layer_norm.bias"),
        "wq": stack("self_attn.q_proj.weight", True),
        "bq": stack("self_attn.q_proj.bias"),
        "wk": stack("self_attn.k_proj.weight", True),
        "bk": stack("self_attn.k_proj.bias"),
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


def lm_params_from_state_dict(sd: Mapping[str, Any], cfg: QwenASRConfig,
                              dtype=np.float32) -> Dict[str, Any]:
    """LM-only param tree (no audio tower) from a text-only Qwen state
    dict: the local translation backend loads instruct checkpoints this
    way. The head falls back to the tied embedding, copied."""
    sd = _strip_prefixes(sd)
    if "lm_head.weight" in sd:
        lm_head = _np(sd["lm_head.weight"]).T.astype(dtype)
    else:
        lm_head = _np(sd["model.embed_tokens.weight"]).T.astype(dtype)
    return {
        "tok_emb": _np(sd["model.embed_tokens.weight"]).astype(dtype),
        "blocks": _stack_lm_blocks(sd, cfg, dtype),
        "ln_f": _np(sd["model.norm.weight"]).astype(dtype),
        "lm_head": lm_head,
    }


def params_from_hf_state_dict(
    sd: Mapping[str, Any], cfg: QwenASRConfig, dtype=np.float32,
    audio_fallback: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Convert an HF Qwen3-ASR/Qwen3 state dict to our param tree.

    ``audio_fallback``: audio-tower subtree to use when the state dict
    has no ``audio_tower.*`` keys (text-only checkpoints).
    """
    sd = _strip_prefixes(sd)
    params = lm_params_from_state_dict(sd, cfg, dtype)

    if any(k.startswith("audio_tower.") for k in sd):
        params["audio"] = {
            "conv2d1_w": _np(sd["audio_tower.conv2d1.weight"]).astype(dtype),
            "conv2d1_b": _np(sd["audio_tower.conv2d1.bias"]).astype(dtype),
            "conv2d2_w": _np(sd["audio_tower.conv2d2.weight"]).astype(dtype),
            "conv2d2_b": _np(sd["audio_tower.conv2d2.bias"]).astype(dtype),
            "conv2d3_w": _np(sd["audio_tower.conv2d3.weight"]).astype(dtype),
            "conv2d3_b": _np(sd["audio_tower.conv2d3.bias"]).astype(dtype),
            "conv_out_w": _np(sd["audio_tower.conv_out.weight"]).T.astype(dtype),
            "blocks": _stack_audio_blocks(sd, cfg, dtype),
            "ln_post_s": _np(sd["audio_tower.ln_post.weight"]).astype(dtype),
            "ln_post_b": _np(sd["audio_tower.ln_post.bias"]).astype(dtype),
            "proj1_w": _np(sd["audio_tower.proj1.weight"]).T.astype(dtype),
            "proj1_b": _np(sd["audio_tower.proj1.bias"]).astype(dtype),
            "proj2_w": _np(sd["audio_tower.proj2.weight"]).T.astype(dtype),
            "proj2_b": _np(sd["audio_tower.proj2.bias"]).astype(dtype),
        }
    elif audio_fallback is not None:
        params["audio"] = audio_fallback
    else:
        raise KeyError("state dict has no audio_tower.* keys and no "
                       "audio_fallback was provided")
    return params


def load_pretrained(model_name_or_path: str, dtype=np.float32):
    """Load a Qwen3-ASR checkpoint via transformers (local path/HF cache).

    Returns (config, params). Zero-egress environment: the checkpoint
    must already be on disk. Raises ImportError where transformers is not
    installed (no fallback to random weights).
    """
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"reading the Qwen3-ASR checkpoint {model_name_or_path!r} needs "
            "the transformers package, which is not installed; run "
            "without --checkpoint for seeded random weights") from e

    hf = transformers.AutoModel.from_pretrained(
        model_name_or_path, trust_remote_code=False, local_files_only=True)
    cfg = config_from_hf(hf.config)
    params = params_from_hf_state_dict(hf.state_dict(), cfg, dtype)
    return cfg, params


# the translator's LM families, by config.json's model_type
LM_FAMILIES = ("the Qwen3 block (model_type qwen3) and the DeepSeek-V3 "
               "block (model_type deepseek_v3)")


def _model_type(path: str) -> Optional[str]:
    """A local checkpoint directory's ``config.json`` ``model_type``
    (None where there is no such file)."""
    cfg = Path(path) / "config.json"
    if not cfg.is_file():
        return None
    return json.loads(cfg.read_text()).get("model_type")


def load_lm(model_name_or_path: str, dtype=np.float32):
    """Load a text-only causal LM for text generation on the card, its
    family picked by ``config.json``'s ``model_type``.

    A Qwen3-family checkpoint (``qwen3``, e.g. a local Qwen3 instruct
    checkpoint) returns (config, numpy tree) with no ``audio`` subtree,
    for :func:`whisperjav_tpu_torch.models.qwen.model.generate_text`
    through ``weights.params_from_jax``; one without Qwen3's per-head q/k
    norms (Qwen2.5-style, ``qwen2``) is refused. A ``deepseek_v3``
    checkpoint (e.g. Kanana-2-30B-A3B) returns (``DeepseekV3Config``, a
    layer source that reads its safetensors lazily), for
    ``models/deepseek_v3/model.py:place``, which quantises each matrix as
    it moves to the card. Any other ``model_type`` is refused. Raises
    ImportError where transformers (Qwen3) or safetensors (DeepSeek-V3)
    is not installed.
    """
    kind = _model_type(model_name_or_path)
    if kind == "deepseek_v3":
        from whisperjav_tpu_torch.models.deepseek_v3.convert import load
        return load(model_name_or_path)
    if kind not in (None, "qwen3", "qwen2"):
        raise ValueError(f"{model_name_or_path}: model_type {kind!r}; the "
                         f"translator's LM implements {LM_FAMILIES}")
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"reading the Qwen3 checkpoint {model_name_or_path!r} needs the "
            "transformers package, which is not installed") from e

    hf = transformers.AutoModelForCausalLM.from_pretrained(
        model_name_or_path, trust_remote_code=False, local_files_only=True)
    cfg = config_from_hf(hf.config)
    sd = hf.state_dict()
    if "model.layers.0.self_attn.q_norm.weight" not in _strip_prefixes(sd):
        raise ValueError(
            "checkpoint lacks q/k-norm weights (Qwen2.5-style); the "
            f"translator's LM implements {LM_FAMILIES}")
    return cfg, lm_params_from_state_dict(sd, cfg, dtype)
