"""WhisperSeg VAD: Whisper-base encoder + 2-layer decoder frame head, in PyTorch.

Counterpart of ``whisperjav_tpu/models/vad/whisperseg.py`` and of the
reference's default segmenter, the TransWithAI/Whisper-Vad-EncDec-ASMR
ONNX export (reference: whisperjav/modules/speech_segmentation/backends/
whisperseg.py:42-130): a Whisper **encoder + 2-layer decoder** (input
(1, 80, 3000) log-mel → (1, 1500) frame logits @20 ms), so the published
weights port through :func:`params_from_hf_state_dict`.

The decoder runs teacher-forced over 1500 fixed query tokens (a constant
token id, positions 0..1499, causal self-attention — HF WhisperDecoder
semantics) with cross-attention to the encoder states, in one
``decode_hidden`` prefill; a (d, 1) linear head on the decoder hidden
states emits the per-frame speech logits. It runs on the port's Whisper
(``models/whisper/model.py``), so on the card the encoder's attention is
Kernel A at (B, 1500, 8, 64) and the decoder's cross-attention is Kernel
B with R = 1500 query rows per int8 cross-K/V row at T = 1500. Kernel A
takes bf16, so on the card the network runs in bf16, as the engine does
for Whisper; on the CPU it runs in f32. The cross K/V are int8 (the
kernel's operand; the JAX module keeps them in the compute dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.convert import _np, _stack_blocks
from whisperjav_tpu_torch.models.whisper.model import (
    KVCache, Whisper, decode_hidden, encode, precompute_cross_kv,
)
from whisperjav_tpu_torch.models.whisper.weights import (
    init_params as _init_whisper,
)
from whisperjav_tpu_torch.ops.mel import N_SAMPLES, log_mel_spectrogram
from whisperjav_tpu_torch.utils.precision import full_f32

FRAME_S = 0.02          # decoder query resolution: 1500 frames per 30 s
N_FRAMES = 1500
QUERY_TOKEN_ID = 0      # constant decoder input id (vendor export default)

# whisper-base dims with a 2-layer decoder and 1500 decoder positions —
# the shape of the published VAD checkpoint.
SEG_CONFIG = WhisperConfig(
    name="whisperseg-base", n_mels=80, n_audio_ctx=1500, n_audio_state=512,
    n_audio_head=8, n_audio_layer=6, n_vocab=51865, n_text_ctx=N_FRAMES,
    n_text_state=512, n_text_head=8, n_text_layer=2,
)


class WhisperSeg(Whisper):
    """The port's :class:`Whisper` trunk plus the frame head
    (``head.w`` (d, 1), ``head.b`` (1,))."""

    def __init__(self, config: WhisperConfig, tree: Mapping[str, Any]):
        super().__init__(config, tree)
        self.head = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(tree["head"][k]),
                            requires_grad=False) for k in ("w", "b")})


@torch.inference_mode()
def frame_logits(model: WhisperSeg, audio: torch.Tensor,
                 query_token_id: int = QUERY_TOKEN_ID) -> torch.Tensor:
    """audio (B, N_SAMPLES) f32 → frame speech logits (B, n_text_ctx) f32."""
    cfg = model.config
    dtype = model.decoder.tok_emb.dtype
    with full_f32():
        mel = log_mel_spectrogram(audio.float(), n_mels=cfg.n_mels)
    xa = encode(model, mel.to(dtype))
    cross = precompute_cross_kv(model, xa, int8=True)
    b, t = audio.shape[0], cfg.n_text_ctx
    tokens = torch.full((b, t), query_token_id, dtype=torch.long,
                        device=audio.device)
    cache = KVCache.zeros(cfg, b, t, dtype, audio.device)
    hidden = decode_hidden(model, tokens, 0, cache, cross)
    logits = torch.matmul(hidden.float(), model.head["w"].float()) \
        + model.head["b"].float()
    return logits[..., 0]


def probs(model: WhisperSeg, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, N_SAMPLES) → frame speech probs (B, 1500) @20 ms."""
    return torch.sigmoid(frame_logits(model, audio))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator,
                config: WhisperConfig = SEG_CONFIG,
                dtype: torch.dtype = torch.float32,
                device="cpu") -> WhisperSeg:
    """Random weights with the JAX package's init distribution (the
    Whisper trunk's, and a N(0, 1/d) head), drawn from ``generator``,
    which must live on ``device``."""
    trunk = _init_whisper(config, generator, dtype=dtype, device=device)
    d = config.n_text_state
    tree = _tree(trunk)
    tree["head"] = {
        "w": (torch.randn((d, 1), generator=generator, device=device)
              * d ** -0.5).to(dtype),
        "b": torch.zeros((1,), dtype=dtype, device=device)}
    return WhisperSeg(config, tree)


def _tree(model: nn.Module) -> Dict:
    """The JAX package's nested tree of a module's state dict."""
    tree: Dict = {}
    for key, value in model.state_dict().items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def params_from_jax(tree: Mapping[str, Any],
                    config: WhisperConfig = SEG_CONFIG,
                    dtype: Optional[torch.dtype] = None,
                    device="cpu") -> WhisperSeg:
    """The JAX package's tree (``encoder``, ``decoder``, ``head``) →
    :class:`WhisperSeg` on ``device``; ``dtype`` casts every leaf (None
    keeps each leaf's own)."""
    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True)).to(device)
        return t.to(dtype) if dtype is not None else t

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        return leaf(node)
    return WhisperSeg(config, rec(tree))


def config_from_tree(tree: Mapping[str, Any],
                     base: WhisperConfig = SEG_CONFIG) -> WhisperConfig:
    """``base`` with the widths, depths, contexts and vocabulary the
    tree's shapes give (head counts are not in the shapes: ``base``'s)."""
    enc, dec = tree["encoder"], tree["decoder"]
    n_vocab, d = np.shape(dec["tok_emb"])
    return dataclasses.replace(
        base, n_mels=np.shape(enc["conv1_w"])[1],
        n_audio_ctx=np.shape(enc["pos"])[0], n_audio_state=d,
        n_audio_layer=np.shape(enc["blocks"]["wq"])[0], n_vocab=n_vocab,
        n_text_ctx=np.shape(dec["pos_emb"])[0], n_text_state=d,
        n_text_layer=np.shape(dec["blocks"]["wq"])[0])


_HEAD_KEY_CANDIDATES = (
    "head", "frame_head", "classifier", "vad_head", "proj_out", "fc",
)


def params_from_hf_state_dict(
    sd: Mapping[str, Any], config: WhisperConfig = SEG_CONFIG,
    dtype=np.float32,
) -> Dict[str, Any]:
    """Convert an HF-Whisper-style VAD state dict to the JAX tree layout.

    Accepts ``model.encoder.* / model.decoder.*`` (or unprefixed) HF
    Whisper naming for the trunk, plus a (1, d) linear frame head under
    any of the common names (``head.weight``, ``classifier.weight``, …) —
    or, failing those, the unique (1, d)/(d,)-shaped linear outside the
    trunk. Torch Linear (out, in) is transposed to (in, out); per-layer
    leaves are stacked on a leading axis.
    """
    full = dict(sd)
    if any(k.startswith("model.") for k in full):
        trunk = {k[len("model."):]: v for k, v in full.items()
                 if k.startswith("model.")}
        extra = {k: v for k, v in full.items() if not k.startswith("model.")}
    else:
        trunk = {k: v for k, v in full.items()
                 if k.startswith(("encoder.", "decoder."))}
        extra = {k: v for k, v in full.items()
                 if not k.startswith(("encoder.", "decoder."))}

    head_w = head_b = None
    for cand in _HEAD_KEY_CANDIDATES:
        if f"{cand}.weight" in extra:
            head_w = _np(extra[f"{cand}.weight"])
            head_b = _np(extra.get(f"{cand}.bias", np.zeros((1,))))
            break
    if head_w is None:
        d = config.n_text_state
        matches = [k for k, v in extra.items()
                   if k.endswith(".weight") and _np(v).shape == (1, d)]
        if len(matches) == 1:
            head_w = _np(extra[matches[0]])
            head_b = _np(extra.get(matches[0][:-len(".weight")] + ".bias",
                                   np.zeros((1,))))
    if head_w is None:
        raise KeyError(
            "no (1, d) frame-head linear found in state dict; expected one "
            f"of {_HEAD_KEY_CANDIDATES} or a unique (1, {config.n_text_state})"
            " weight outside model.*")

    def a(key):
        return _np(trunk[key]).astype(dtype)

    return {
        "encoder": {
            "conv1_w": a("encoder.conv1.weight"),
            "conv1_b": a("encoder.conv1.bias"),
            "conv2_w": a("encoder.conv2.weight"),
            "conv2_b": a("encoder.conv2.bias"),
            "pos": a("encoder.embed_positions.weight"),
            "blocks": _stack_blocks(trunk, "encoder", config.n_audio_layer,
                                    False, dtype),
            "ln_s": a("encoder.layer_norm.weight"),
            "ln_b": a("encoder.layer_norm.bias"),
        },
        "decoder": {
            "tok_emb": a("decoder.embed_tokens.weight"),
            "pos_emb": a("decoder.embed_positions.weight"),
            "blocks": _stack_blocks(trunk, "decoder", config.n_text_layer,
                                    True, dtype),
            "ln_s": a("decoder.layer_norm.weight"),
            "ln_b": a("decoder.layer_norm.bias"),
        },
        "head": {
            "w": head_w.T.astype(dtype),       # (1, d) → (d, 1)
            "b": head_b.astype(dtype),
        },
    }


# ---------------------------------------------------------------------------
# npz round-trip (the JAX package's local checkpoint format)
# ---------------------------------------------------------------------------

def load_tree(path: str) -> Dict:
    """The JAX package's ``.npz`` (flat 'a/b/c' keys) → nested numpy tree."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def load_params(path: str, config: Optional[WhisperConfig] = None,
                dtype: Optional[torch.dtype] = None,
                device="cpu") -> WhisperSeg:
    """Load a ``.npz`` written by either package; ``config`` defaults to
    SEG_CONFIG with the widths and depths of the file's shapes."""
    tree = load_tree(path)
    return params_from_jax(tree, config or config_from_tree(tree), dtype,
                           device)


def save_params(path: str, model: WhisperSeg) -> None:
    """Write the JAX package's ``.npz`` layout (flat 'a/b/c' keys)."""
    np.savez(path, **{key.replace(".", "/"): value.detach().float().cpu().numpy()
                      for key, value in model.state_dict().items()})

