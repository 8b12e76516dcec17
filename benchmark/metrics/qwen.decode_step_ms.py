"""Device milliseconds a Qwen3-ASR decode step: the device's busy time
inside the profiled file's ``decode.loop`` spans under a ``qwen.batch``
(the port opens the loop after the prefill's end on the device and
closes it once the device has run the last step), over the steps those
loops ran (their ``steps`` counters): the step's device work, without
the time the device waits for the host. Nothing to read from a port
that records no such spans, or without a device trace."""

from h100bench.spans import Busy, program_spans

LAYER = "qwen (models/qwen/model.py, subtitle_pipeline/components.py QwenGenerator)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    if not any(s.name == "qwen.batch" for s in spans) or not stretch.spans:
        return None
    loops = [s for s in spans if s.name == "decode.loop"]
    steps = sum(s.counters.get("steps", 0) for s in loops)
    if not steps:
        return None
    busy = Busy(stretch.spans)
    return sum(busy.within(s.start_ns, s.end_ns) for s in loops) \
        / 1e6 / steps
