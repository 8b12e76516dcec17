"""The share of Qwen3-ASR's decode layer-steps whose column attention ran
the hand-written kernel (``csrc/qwen_column_attention.cu``), as the port
counts them: the ``kernel_layers`` counters of the profiled file's
``decode.loop`` spans under a ``qwen.batch`` over their ``steps`` times
the LM's layers, in percent. Nothing to read from a port whose loops
count no ``kernel_layers``, or that records no such spans."""

from h100bench.spans import program_spans

LAYER = "qwen (models/qwen/model.py, subtitle_pipeline/components.py QwenGenerator)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    if not any(s.name == "qwen.batch" for s in spans):
        return None
    loops = [s.counters for s in spans if s.name == "decode.loop"]
    steps = sum(c.get("steps", 0) for c in loops)
    if not steps or not any("kernel_layers" in c for c in loops):
        return None
    return 100.0 * sum(c.get("kernel_layers", 0) for c in loops) \
        / (steps * stretch.model["n_layers"])
