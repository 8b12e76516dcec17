"""The Qwen3 decode step's column attention's share of its roofline: the
least time of the attention the profiled file's decode loops ran, over
the device seconds of ``qwen_column_attention_kernel``, in percent.

The work is reckoned from each ``decode.loop`` span under a
``qwen.batch``: its ``rows`` at every step's position (``start``, the
first generated token's, plus the step) for ``steps`` steps, in every LM
layer; whatever implements it, a layer-step reads each row's filled
positions of the layer's K and V once at the cache's itemsize, reads the
new column and writes it, reads q and writes the output (the bytes, at
3.35 TB/s, bound it: 4 FLOP per query head, position and dimension at
the f32 peak take ~1/8 of that). Nothing to read without the kernel in
the trace, or from loops that count no ``start``."""

from h100bench.spans import program_spans
from roofline.counts import PEAK_F32, least_s

LAYER = "qwen column attention (csrc/qwen_column_attention.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"
KERNELS = ("qwen_column_attention_kernel",)


def layer_step(m: dict, rows: int, pos: int, itemsize: int) -> tuple:
    """(flop, bytes) of one layer's attention for ``rows`` rows whose
    caches hold ``pos`` positions each."""
    hd = m["lm_head_dim"] or m["d_model"] // m["n_heads"]
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    nbytes = itemsize * rows * (2 * pos * kvd + 2 * 2 * kvd + 2 * qd)
    return 4 * rows * qd * (pos + 1), nbytes


def read(stretch):
    spent = stretch.kernel_s(KERNELS)
    spans = program_spans(stretch)
    if not spent or not any(s.name == "qwen.batch" for s in spans):
        return None
    loops = [s.counters for s in spans
             if s.name == "decode.loop" and "start" in s.counters]
    if not loops:
        return None
    m, itemsize = stretch.model, stretch.decode["kv_itemsize"]
    least = sum(m["n_layers"] * least_s(*layer_step(m, c["rows"],
                                                     c["start"] + t,
                                                     itemsize), PEAK_F32)
                for c in loops for t in range(c["steps"]))
    return 100.0 * least / spent
