"""Share of the stretch's host wall in which the device ran nothing while
the port's decode loop ran: the device's idle time inside the
``decode.loop`` spans (the host's logit rules, beam selection, the
forward's enqueue and the per-step wait for the stop flag), over the
wall. Nothing to read without program or device spans."""

from h100bench.spans import Busy, idle_within, program_spans

LAYER = "decoder step (models/whisper/decode.py, model.py decoder)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    loops = [s for s in program_spans(stretch) if s.name == "decode.loop"]
    if not loops or not stretch.spans or stretch.wall_s <= 0:
        return None
    return 100.0 * idle_within(Busy(stretch.spans), loops) / stretch.wall_s
