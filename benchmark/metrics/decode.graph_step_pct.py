"""The share of decode steps whose forward was a CUDA graph's replay, as
the port counts them: the ``graph_steps`` counters of the profiled
file's ``decode.loop`` spans over their ``steps``, in percent. Nothing
to read from a port whose loops count no ``graph_steps``, or that
records no spans."""

from h100bench.spans import program_spans

LAYER = "decoder step (models/whisper/decode.py, model.py decoder)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "audio_rtf"


def read(stretch):
    loops = [s.counters for s in program_spans(stretch)
             if s.name == "decode.loop"]
    steps = sum(c.get("steps", 0) for c in loops)
    if not steps or not any("graph_steps" in c for c in loops):
        return None
    return 100.0 * sum(c.get("graph_steps", 0) for c in loops) / steps
