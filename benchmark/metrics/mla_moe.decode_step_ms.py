"""Device milliseconds a decode step of the translator's DeepSeek-V3-block
LM: the device's busy time inside the profiled file's ``decode.loop``
spans that lie within a ``translate.prompt`` (``LocalLMBackend.
generate_ids``; the port opens the loop after the prefill's end on the
device and closes it once the device has run the last step), over the
steps those loops ran (their ``steps`` counters): the absorbed step's
device work, without the time the device waits for the host. Nothing
to read from a port that records no such spans, or without a device
trace."""

from h100bench.spans import Busy, program_spans

LAYER = "mla_moe (models/deepseek_v3/model.py, translate/local_backend.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def prompt_loops(spans) -> list:
    """The ``decode.loop`` spans inside a ``translate.prompt`` span."""
    prompts = [s for s in spans if s.name == "translate.prompt"]
    return [s for s in spans if s.name == "decode.loop" and any(
        p.start_ns <= s.start_ns and s.end_ns <= p.end_ns for p in prompts)]


def read(stretch):
    if not stretch.spans:
        return None
    loops = prompt_loops(program_spans(stretch))
    steps = sum(s.counters.get("steps", 0) for s in loops)
    if not steps:
        return None
    busy = Busy(stretch.spans)
    return sum(busy.within(s.start_ns, s.end_ns) for s in loops) \
        / 1e6 / steps
