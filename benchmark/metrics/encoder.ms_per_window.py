"""Device milliseconds of log-mel and the encoder a window: the kernels
of the engine's side stream (every encode runs there, behind its
upload; it is the stream that runs Kernel A) over the rows the stretch
encoded."""

LAYER = "encoder (ops/mel.py, models/whisper/model.py:encode)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    stream = stretch.stream_of("encoder_attention_kernel")
    rows = sum(b["rows"] for b in stretch.batches)
    if stream is None or not rows:
        return None
    return 1e3 * stretch.stream_kernel_s(stream) / rows
