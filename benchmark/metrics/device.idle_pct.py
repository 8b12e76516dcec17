"""Share of the stretch's host wall in which nothing ran on the device:
the wall less the union of the device's activity intervals, over the
wall."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    if not stretch.spans or stretch.wall_s <= 0:
        return None
    return 100.0 * (stretch.wall_s - stretch.busy_s()) / stretch.wall_s
