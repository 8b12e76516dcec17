"""Device milliseconds of Qwen3-ASR's prefill a row: the device's busy
time inside the profiled file's ``qwen.prefill`` spans (the cache made,
the audio prefix and BOS through every LM layer, the head; the port
closes the span once the device has run it, and opens it after the
tower's end), over the rows of its ``qwen.batch`` spans. Nothing to
read from a port that records no such spans, or without a device
trace."""

from h100bench.spans import Busy, program_spans

LAYER = "qwen (models/qwen/model.py, subtitle_pipeline/components.py QwenGenerator)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    rows = sum(s.counters.get("rows", 0) for s in spans
               if s.name == "qwen.batch")
    stages = [s for s in spans if s.name == "qwen.prefill"]
    if not rows or not stages or not stretch.spans:
        return None
    busy = Busy(stretch.spans)
    return sum(busy.within(s.start_ns, s.end_ns) for s in stages) \
        / 1e6 / rows
