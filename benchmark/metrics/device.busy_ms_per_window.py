"""Device milliseconds a window: the union of the device's activity
intervals over the rows the stretch served (``Stretch.rows``, as the
driver counts them: Whisper's windows). The device's share of
``audio_rtf``, without the host's time: steadier from run to run than
the walls the host sets."""

LAYER = "device"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_rtf"


def read(stretch):
    if not stretch.spans or not stretch.rows:
        return None
    return 1e3 * stretch.busy_s() / stretch.rows
