"""The fused int8 decode blocks' share of their roofline, Kernel B
inside the cross block counted under its own metric: the least time of
the six int8 GEMVs (LayerNorm folded into the first of each block, the
residual into the last) and the in-block self-attention of every
decoder layer of every step, over the device time of ``qgemv_kernel``
and ``self_attention_kernel``. Nothing to read where the blocks do not
run (bf16 decoder weights)."""

from roofline.counts import fused_without_kernel_b, least_s

LAYER = "fused int8 blocks (csrc/fused_decode.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"
KERNELS = ("qgemv_kernel", "self_attention_kernel")


def read(stretch):
    spent = stretch.kernel_s(KERNELS)
    if not spent:
        return None
    m, dec = stretch.model, stretch.decode
    d, h = m["d_model"], m["attention_heads"]
    least = 0.0
    for b in stretch.batches:
        rows = b["rows"] * dec["beams"]
        for step in range(b["steps"]):
            pos = dec["prompt_len"] + step
            least += m["decoder_layers"] * least_s(*fused_without_kernel_b(
                rows, pos, b["rows"], b["bucket"], d, h))
    return 100.0 * least / spent
