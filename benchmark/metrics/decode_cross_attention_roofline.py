"""Kernel B's share of its roofline, every form and caller: the least
time of the cross-attention the stretch computed (each decoder layer of
the prompt's prefill and of every step, over the batch's int8 K/V at
its bucket, the beams and prompt positions folded onto a K/V row), over
the device time of ``decode_cross_attention_kernel``."""

from roofline.counts import cross_attention_s

LAYER = "kernel B (csrc/decode_cross_attention.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"
KERNELS = ("decode_cross_attention_kernel",)


def read(stretch):
    spent = stretch.kernel_s(KERNELS)
    if not spent:
        return None
    m, dec = stretch.model, stretch.decode
    beams = dec["beams"]
    least = 0.0
    for b in stretch.batches:
        prefill = cross_attention_s(b["rows"], beams * dec["prompt_len"],
                                    b["bucket"], m["d_model"])
        step = cross_attention_s(b["rows"], beams, b["bucket"], m["d_model"])
        least += m["decoder_layers"] * (prefill + b["steps"] * step)
    return 100.0 * least / spent
