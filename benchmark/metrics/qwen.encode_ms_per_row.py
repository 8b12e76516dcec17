"""Device milliseconds of Qwen3-ASR's audio encode a row: the device's
busy time from each batch's ``qwen.mel`` span's start to its
``qwen.encode`` span's end (the mel's upload and log-mel, then the AuT
tower; the port closes ``qwen.encode`` once the device has run it, so
its work lies inside), over the rows of the profiled file's
``qwen.batch`` spans. Nothing to read from a port that records no such
spans, or without a device trace."""

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
    start = {s.batch: s.start_ns for s in spans if s.name == "qwen.mel"}
    stages = [(start[s.batch], s.end_ns) for s in spans
              if s.name == "qwen.encode" and s.batch in start]
    if not rows or not stages or not stretch.spans:
        return None
    busy = Busy(stretch.spans)
    return sum(busy.within(a, b) for a, b in stages) / 1e6 / rows
