"""Kernel A's share of its roofline: the least time of the encoder
self-attention the stretch computed (every encoder layer of every
encoded row, at 1500 frames), over the device time of
``encoder_attention_kernel``."""

from roofline.counts import encoder_attention_s

LAYER = "kernel A (csrc/encoder_attention.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"
KERNELS = ("encoder_attention_kernel",)


def read(stretch):
    spent = stretch.kernel_s(KERNELS)
    if not spent:
        return None
    m = stretch.model
    h = m["attention_heads"]
    least = sum(m["encoder_layers"] * encoder_attention_s(
        b["rows"], m["n_audio_ctx"], h, m["d_model"] // h)
        for b in stretch.batches)
    return 100.0 * least / spent
