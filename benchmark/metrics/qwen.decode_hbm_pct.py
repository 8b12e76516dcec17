"""Qwen3-ASR's decode steps' share of the card's memory rate: their
least bytes (``roofline/qwen3_asr.step_bytes``: the int8 LM weights and
head with their scales once a step, each live row's own filled
positions of K and V at the cache's stated precision, and the new
column; a row is live for the steps its own tokens took, counted by the
driver in ``Stretch.batches``) at 3.35 TB/s, over the device's busy
seconds inside the profiled file's ``decode.loop`` spans under a
``qwen.batch`` (as ``qwen.decode_step_ms`` reads them), in percent.
Nothing to read from a port that records no such spans, or without a
device trace."""

from h100bench.spans import Busy, program_spans
from roofline.counts import HBM_BYTES_S
from roofline.qwen3_asr import step_bytes

LAYER = "qwen (models/qwen/model.py, subtitle_pipeline/components.py QwenGenerator)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    if not any(s.name == "qwen.batch" for s in spans) or not stretch.spans:
        return None
    loops = [s for s in spans if s.name == "decode.loop"]
    batches = [b for b in stretch.batches if "prefix" in b]
    if not loops or len(loops) != len(batches):
        return None
    least = 0
    for loop, b in zip(loops, batches):
        for t in range(min(loop.counters["steps"], max(b["steps"]))):
            filled = [p + t for p, n in zip(b["prefix"], b["steps"]) if t < n]
            least += step_bytes(stretch.model, filled,
                                stretch.decode["kv_itemsize"])
    busy = Busy(stretch.spans)
    seconds = sum(busy.within(s.start_ns, s.end_ns) for s in loops) / 1e9
    return 100.0 * least / HBM_BYTES_S / seconds if seconds else None
