"""Host milliseconds a decode step, as the port times them: the summed
``decode.step`` spans of the profiled file over the steps its
``decode.loop`` spans ran (their ``steps`` counters). The program's own
view of ``decode.step_ms``: the prefill, the wait for the encode and
the finalize left out, the steps counted where they ran. Nothing to
read from a port that records no spans."""

from h100bench.spans import program_spans

LAYER = "decoder step (models/whisper/decode.py, model.py decoder)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    steps = sum(s.counters.get("steps", 0) for s in spans
                if s.name == "decode.loop")
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in spans
                     if s.name == "decode.step") / steps
