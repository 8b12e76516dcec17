"""Qwen3-ASR's operations and the decode step's least bytes, for the
work of a stretch.

Operations count two a multiply-add, at each row's own shapes: its own
seconds rounded up to whole attention windows of the audio tower
(``n_window_infer`` mel frames, 4 s), not the batch's padded length, so
a program that stops padding is credited for it. A row is counted as
its audio tokens through the tower (three 3x3 stride-2 convolutions,
``conv_out``, every layer with attention inside its window, the
adapter), the prefill of its prefix (those tokens and BOS, the head at
the last position only), and each decode step it ran at its position,
attention over the positions filled before it and the new one, with the
head. Int8 products count like any other: ``step_mfu`` holds them to
the bf16 peak.

A decode step's least bytes: the int8 codes of the LM's matmuls and
head with their f32 scales, read once, and each row's filled positions
(its own prefix and the tokens so far) of every layer's K and V at the
cache's stated precision, read once, with the new column written.
"""

from __future__ import annotations

from typing import Sequence

SR = 16_000
HOP = 160


def _half(n: int) -> int:
    """A length after one 3x3 stride-2 convolution padded by one."""
    return (n + 1) // 2


def chunk_frames(m: dict) -> int:
    return 2 * m["n_window"]


def chunk_tokens(m: dict) -> int:
    return _half(_half(_half(chunk_frames(m))))


def window_tokens(m: dict) -> int:
    return chunk_tokens(m) * (m["n_window_infer"] // chunk_frames(m))


def audio_tokens(m: dict, samples: int) -> int:
    """The tower's tokens for ``samples`` of audio at 16 kHz, rounded up
    to whole attention windows."""
    windows = -(-samples // (m["n_window_infer"] * HOP))
    return max(1, windows) * window_tokens(m)


def tower_flops(m: dict, tokens: int) -> float:
    """The audio tower over ``tokens`` audio tokens (whole chunks)."""
    chunks = tokens // chunk_tokens(m)
    h, da = m["audio_downsample_hidden"], m["d_audio"]
    f, t, conv = m["n_mels"], chunk_frames(m), 0
    for c_in in (1, h, h):
        f, t = _half(f), _half(t)
        conv += 2 * h * f * t * c_in * 9
    conv += 2 * t * (h * f) * da
    w = window_tokens(m)
    layer = 8 * da * da + 4 * da * m["audio_ffn"] + 4 * w * da
    adapter = 2 * da * da + 2 * da * m["d_model"]
    return chunks * conv + tokens * (m["audio_layers"] * layer + adapter)


def _dims(m: dict) -> tuple:
    hd = m["lm_head_dim"] or m["d_model"] // m["n_heads"]
    return m["d_model"], m["n_heads"] * hd, m["n_kv_heads"] * hd


def lm_position_flops(m: dict, pos: int) -> float:
    """Every LM layer at position ``pos``, attending over ``pos + 1``
    positions; the head apart."""
    d, qd, kvd = _dims(m)
    layer = (2 * d * (qd + 2 * kvd) + 2 * qd * d + 6 * d * m["d_ff"]
             + 4 * qd * (pos + 1))
    return m["n_layers"] * layer


def head_flops(m: dict) -> float:
    return 2 * m["d_model"] * m["vocab_size"]


def row_flops(m: dict, samples: int, steps: int) -> float:
    """One row of ``samples`` of audio: tower, prefill and ``steps``
    decode steps."""
    tokens = audio_tokens(m, samples)
    prefix = tokens + 1
    prefill = sum(lm_position_flops(m, p) for p in range(prefix))
    decode = sum(lm_position_flops(m, prefix + t) for t in range(steps))
    return (tower_flops(m, tokens) + prefill + head_flops(m)
            + decode + steps * head_flops(m))


def weight_bytes(m: dict) -> int:
    """The int8 codes of the LM's matmuls and head with their f32
    per-output-channel scales."""
    d, qd, kvd = _dims(m)
    ff, v = m["d_ff"], m["vocab_size"]
    codes = m["n_layers"] * (d * (qd + 2 * kvd) + qd * d + 3 * d * ff) + d * v
    scales = 4 * (m["n_layers"] * ((qd + 2 * kvd) + d + 2 * ff + d) + v)
    return codes + scales


def kv_position_bytes(m: dict, itemsize: int) -> int:
    """K and V of one position in every LM layer."""
    return 2 * m["n_layers"] * _dims(m)[2] * itemsize


def step_bytes(m: dict, filled: Sequence[int], itemsize: int) -> int:
    """One decode step's least bytes over rows whose caches hold
    ``filled`` positions each: the weights, each row's positions, and
    the new column written."""
    pos = kv_position_bytes(m, itemsize)
    return weight_bytes(m) + pos * (sum(filled) + len(filled))
