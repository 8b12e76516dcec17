"""Share of the encodes' device time that ran beside work of another
stream: the engine's encode-ahead and decode-ahead at work.

The engine runs every encode on its side stream, the stream that runs
Kernel A; the device seconds in which two or more streams ran at once,
over that stream's kernel seconds."""

LAYER = "engine (pipelines/engine.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    stream = stretch.stream_of("encoder_attention_kernel")
    if stream is None:
        return None
    encode_s = stretch.stream_kernel_s(stream)
    return 100.0 * stretch.concurrent_s() / encode_s if encode_s else None
