"""The translator's DeepSeek-V3-block decode steps' share of the card's
memory rate: their least bytes (``roofline/deepseek_v3.step_bytes``: the
int8 codes and scales of the attention, the dense layer, the six routed
experts and the shared ones of each expert layer and the head, the f32
router and correction bias, the filled latent positions and the new
column), one row's, a step at its own position (the loop's ``start``
counter plus the steps before it), at 3.35 TB/s, over the device's busy
seconds inside the profiled file's ``decode.loop`` spans within a
``translate.prompt`` (as ``mla_moe.decode_step_ms`` reads them), in
percent. Nothing to read from a port that records no such spans, or
without a device trace."""

from h100bench.spans import Busy, program_spans
from h100bench.spec import metric
from roofline.counts import HBM_BYTES_S
from roofline.deepseek_v3 import step_bytes

LAYER = "mla_moe (models/deepseek_v3/model.py, translate/local_backend.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    if not stretch.spans or "latent_itemsize" not in stretch.decode:
        return None
    loops = metric("mla_moe.decode_step_ms").prompt_loops(
        program_spans(stretch))
    if not loops:
        return None
    itemsize = stretch.decode["latent_itemsize"]
    least = sum(step_bytes(stretch.model, s.counters["start"] + t, itemsize)
                for s in loops for t in range(s.counters["steps"]))
    busy = Busy(stretch.spans)
    seconds = sum(busy.within(s.start_ns, s.end_ns) for s in loops) / 1e9
    return 100.0 * least / HBM_BYTES_S / seconds if seconds else None
