"""Whisper's operations for the work of a stretch, for ``step_mfu``.

Two operations a multiply-add, at the shapes run: the encoder forward a
window (the two convolutions and every layer at 1500 frames), the
cross-K/V projections a window at its batch's bucket, and the decoder a
decode row a step (every layer's projections, self-attention over the
positions so far, cross-attention over the bucket, and the head). The
prompt's prefill counts as its positions' steps. Int8 products count
like bf16 ones: the peak they are held to is the bf16 one.
"""

from __future__ import annotations


def encoder_window(m: dict) -> float:
    d, t = m["d_model"], m["n_audio_ctx"]
    conv = 2 * (2 * t) * m["n_mels"] * 3 * d + 2 * t * 3 * d * d
    layer = 24 * t * d * d + 4 * t * t * d
    return conv + m["encoder_layers"] * layer


def cross_kv_window(m: dict, bucket: int) -> float:
    return m["decoder_layers"] * 4 * bucket * m["d_model"] ** 2


def decoder_token(m: dict, pos: int, bucket: int) -> float:
    """One decode row's token at position ``pos`` (the positions before
    it cached) against ``bucket`` cross frames."""
    d = m["d_model"]
    layer = 28 * d * d + 4 * (pos + 1) * d + 4 * bucket * d
    return m["decoder_layers"] * layer + 2 * d * m["vocab_size"]


def batch(m: dict, bucket: int, rows: int, beams: int, steps: int,
          prompt_len: int) -> float:
    """A batch of ``rows`` windows: encoded, cross-K/V projected, and
    ``beams`` decode rows each through the prompt and ``steps`` steps."""
    dec = sum(decoder_token(m, p, bucket)
              for p in range(prompt_len + steps))
    return rows * (encoder_window(m) + cross_kv_window(m, bucket)
                   + beams * dec)
