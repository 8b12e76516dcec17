"""Device milliseconds of the translator's DeepSeek-V3-block prefill a
thousand prompt tokens: the device's busy time inside the profiled
file's ``lm.prefill`` spans (the latent cache made, the prompt through
every layer in the full form, its tokens grouped by expert, the head at
the last position; the port closes the span once the device has run
it), over the ``prompt_tokens`` of their ``translate.prompt`` spans.
Nothing to read from a port that records no such spans, or without a
device trace."""

from h100bench.spans import Busy, program_spans

LAYER = "mla_moe (models/deepseek_v3/model.py, translate/local_backend.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    tokens = sum(s.counters.get("prompt_tokens", 0) for s in spans
                 if s.name == "translate.prompt")
    stages = [s for s in spans if s.name == "lm.prefill"]
    if not tokens or not stages or not stretch.spans:
        return None
    busy = Busy(stretch.spans)
    return sum(busy.within(s.start_ns, s.end_ns) for s in stages) \
        / 1e6 / (tokens / 1000)
