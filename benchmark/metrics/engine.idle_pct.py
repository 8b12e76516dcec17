"""Share of the stretch's host wall in which the device ran nothing while
the port's engine did other host work than decoding: the device's idle
time inside the program's spans but outside every ``decode.loop`` span
(uploads, encode enqueues, drains, the ladder's host side, segment
extraction, the deferred retry's), over the wall. With
``decode.idle_pct`` it accounts for ``device.idle_pct`` less the idle
time no span covers. Nothing to read without program or device spans."""

from h100bench.spans import Busy, idle_within, program_spans

LAYER = "engine (pipelines/engine.py)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    spans = program_spans(stretch)
    if not spans or not stretch.spans or stretch.wall_s <= 0:
        return None
    busy = Busy(stretch.spans)
    idle = idle_within(busy, spans) - idle_within(
        busy, [s for s in spans if s.name == "decode.loop"])
    return 100.0 * idle / stretch.wall_s
