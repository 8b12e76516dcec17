"""Word-level timestamps from decoder cross-attention (DTW), in PyTorch.

Counterpart of ``whisperjav_tpu/models/whisper/word_align.py``: a
teacher-forced decoder pass over the decoded tokens (causal
self-attention over the whole sequence) accumulates the cross-attention
probabilities of selected alignment heads into a (tokens x audio frames)
matrix, and a monotonic Viterbi path (shared with the Qwen aligner)
gives each token a frame span at 20 ms resolution.

The pass runs as plain PyTorch ops on the port's :class:`Whisper` on
the encoder states' device: the engine's fused ``wqkv`` leaves and the
int8 leaves of ``--int8-weights`` go through the model's ``dense``; the
cross-attention is taken from the float ``cwk``/``cwv`` projections of
the encoder states, not from the int8 cross K/V of decoding. Without a
model-specific head table the head set is every head in the top half of
the decoder layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from whisperjav_tpu_torch.models.qwen.aligner import monotonic_align
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.layers import layer_norm
from whisperjav_tpu_torch.models.whisper.model import (
    Whisper, dense, split_heads,
)
from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda.encoder_attention import attention

FRAME_S = 0.02


def default_head_mask(config: WhisperConfig) -> np.ndarray:
    """(L, H) float mask over alignment heads, summing to one: the
    config's per-model head table when it carries one, otherwise every
    head in the top half of the decoder layers."""
    mask = np.zeros((config.n_text_layer, config.n_text_head), np.float32)
    if config.alignment_heads:
        for layer, head in config.alignment_heads:
            if 0 <= layer < config.n_text_layer \
                    and 0 <= head < config.n_text_head:
                mask[layer, head] = 1.0
    if mask.sum() == 0:
        mask[config.n_text_layer // 2:, :] = 1.0
    return mask / max(mask.sum(), 1.0)


@torch.inference_mode()
def cross_attention_maps(
    model: Whisper,
    tokens: torch.Tensor,       # (B, S) teacher-forced token ids
    xa: torch.Tensor,           # (B, T_a, d) encoder states
    head_mask: torch.Tensor,    # (L, H) weights over alignment heads
) -> torch.Tensor:
    """Teacher-forced decoder pass -> (B, S, T_a) f32 attention mass.

    Each call counts one in ``cross_attention_maps.launches``."""
    dec = model.decoder
    p = dec.blocks
    b, s = tokens.shape
    dtype = dec.tok_emb.dtype
    hd = model.config.n_text_state // model.config.n_text_head
    x = (dec.tok_emb[tokens] + dec.pos_emb[:s]).to(dtype)
    xa = xa.to(dtype)
    idx = torch.arange(s, device=tokens.device)
    causal = torch.where(idx[None, :] <= idx[:, None], 0.0,
                         float("-inf"))[None, None]
    head_mask = head_mask.to(device=xa.device, dtype=torch.float32)
    acc = torch.zeros((b, s, xa.shape[1]), dtype=torch.float32,
                      device=xa.device)
    for i in range(p["ln1_s"].shape[0]):
        # self-attention over the whole sequence, causal
        h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
        if "wqkv" in p:
            d = h.shape[-1]
            qkv = dense(h, p["wqkv"][i], p["bqkv"][i])
            q, k, v = (split_heads(qkv[..., j * d:(j + 1) * d], hd)
                       for j in range(3))
        else:
            q = split_heads(dense(h, p["wq"][i], p["bq"][i]), hd)
            k = split_heads(dense(h, p["wk"][i]), hd)
            v = split_heads(dense(h, p["wv"][i], p["bv"][i]), hd)
        a = attention(q, k, v, causal)
        x = x + dense(a.reshape(b, s, -1), p["wo"][i], p["bo"][i])
        # cross-attention, its probabilities captured
        h = layer_norm(x, p["lnx_s"][i], p["lnx_b"][i])
        cq = split_heads(dense(h, p["cwq"][i], p["cbq"][i]), hd)
        ck = split_heads(dense(xa, p["cwk"][i]), hd)
        cv = split_heads(dense(xa, p["cwv"][i], p["cbv"][i]), hd)
        sc = cq.shape[-1] ** -0.25
        logits = torch.matmul((cq * sc).float().transpose(1, 2),
                              (ck * sc).float().permute(0, 2, 3, 1))
        cw = torch.softmax(logits, dim=-1)           # (B, H, S, T_a) f32
        acc += torch.einsum("bhqk,h->bqk", cw, head_mask[i])
        a = torch.matmul(cw.to(dtype), cv.transpose(1, 2)).transpose(1, 2)
        x = x + dense(a.reshape(b, s, -1), p["cwo"][i], p["cbo"][i])
        # mlp
        h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
        x = x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                      p["w2"][i], p["b2"][i])
    _build.count(cross_attention_maps)
    return acc


cross_attention_maps.launches = 0


@dataclass
class WordSpan:
    text: str
    start: float
    end: float
    tokens: List[int]


def word_timestamps(
    model: Whisper,
    xa: torch.Tensor,            # (1, T_a, d) one row's encoder states
    generated: np.ndarray,       # (S,) one row of generated ids (eot-padded)
    tokenizer=None,
    head_mask: Optional[np.ndarray] = None,
    audio_duration: Optional[float] = None,
) -> List[WordSpan]:
    """Align one window's generated tokens to its audio -> one span per
    text token (timestamps and specials stripped), in seconds, clamped to
    ``audio_duration``. Token ids and the head table are the model's
    (``model.config``: a vocab-sliced model takes subset ids)."""
    config = model.config
    ids = [int(t) for t in generated if int(t) < config.eot]
    if not ids:
        return []
    if head_mask is None:
        head_mask = default_head_mask(config)
    # the sequence padded to a multiple of 64 with EOT, as in the JAX
    # package (its pass compiles once per length bucket)
    padded_len = ((len(ids) + 1 + 63) // 64) * 64
    seq = [config.sot] + ids + [config.eot] * (padded_len - len(ids) - 1)
    toks = torch.tensor([seq], dtype=torch.long, device=xa.device)
    maps = cross_attention_maps(model, toks, xa,
                                torch.from_numpy(np.asarray(head_mask)))
    maps = maps[0, 1:len(ids) + 1].cpu().numpy()  # drop SOT and padding rows

    # normalise each row over time and take the log for the DTW cost
    maps = maps / (maps.sum(axis=-1, keepdims=True) + 1e-9)
    spans = monotonic_align(np.log(maps + 1e-9))

    out: List[WordSpan] = []
    for tid, (a, b) in zip(ids, spans):
        text = tokenizer.decode([tid]) if tokenizer is not None else str(tid)
        start = a * FRAME_S
        end = max(b * FRAME_S, start + FRAME_S)
        if audio_duration is not None:
            start = min(start, audio_duration)
            end = min(end, audio_duration)
        out.append(WordSpan(text, start, end, [tid]))
    return out
