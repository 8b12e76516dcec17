"""The whole step's share of the card's bf16 peak: the model's
operations for the stretch's work, as the driver counts them
(``Stretch.model_flops``; Whisper's: the encoder a window, the cross-K/V
projections a window, the decoder a decode row a step, prefill and head
included, ``roofline/model_flops.py``), over the stretch's host wall and
989 TFLOP/s. Int8 products count at the bf16 peak."""

from roofline.counts import PEAK_BF16

LAYER = "whole step (pipelines/engine.py transcribe_windows)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "audio_rtf"


def read(stretch):
    if not stretch.model_flops or stretch.wall_s <= 0:
        return None
    return 100.0 * stretch.model_flops / (stretch.wall_s * PEAK_BF16)
