"""Milliseconds a decode step: each ``TranscriptionEngine.decode_encoded``
call's span on the stream that decodes, from its encode being done to
its decode being done (CUDA events the benchmark records there, no
sync), summed and divided by the steps those calls ran (the engine's
budget for each batch's bucket)."""

LAYER = "decoder step (models/whisper/decode.py, model.py decoder)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    steps = sum(n for _, n in stretch.decode_spans)
    if not steps:
        return None
    return 1e3 * sum(s for s, _ in stretch.decode_spans) / steps
