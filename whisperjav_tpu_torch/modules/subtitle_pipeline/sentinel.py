"""Alignment sentinel: detect and repair collapsed forced alignment.

Parity with reference ``whisperjav/modules/alignment_sentinel.py:45-208``
(assess_alignment_quality detects words piled at t≈0 or null timestamps;
redistribute_collapsed_words spreads words across VAD regions
(vad_guided) or proportionally).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from whisperjav_tpu_torch.modules.subtitle_pipeline.types import WordTimestamp


@dataclass
class AlignmentQuality:
    collapsed: bool
    null_fraction: float
    pile_up_fraction: float
    reason: Optional[str] = None


def assess_alignment_quality(
    words: Sequence[WordTimestamp],
    frame_duration: float,
    pile_up_window_s: float = 0.25,
    collapse_threshold: float = 0.6,
) -> AlignmentQuality:
    """Collapsed when most words are null-stamped or piled near t≈0."""
    if not words:
        return AlignmentQuality(False, 0.0, 0.0)
    n = len(words)
    nulls = sum(1 for w in words if w.start is None or w.end is None)
    piled = sum(1 for w in words
                if w.start is not None and w.start <= pile_up_window_s)
    null_frac = nulls / n
    pile_frac = piled / n
    if null_frac >= collapse_threshold:
        return AlignmentQuality(True, null_frac, pile_frac,
                                "mostly null timestamps")
    if n >= 4 and pile_frac >= collapse_threshold:
        return AlignmentQuality(True, null_frac, pile_frac,
                                "words piled at frame start")
    # degenerate zero-span alignment
    spans = [w.end - w.start for w in words
             if w.start is not None and w.end is not None]
    if spans and sum(spans) < 0.02 * frame_duration and n >= 4:
        return AlignmentQuality(True, null_frac, pile_frac,
                                "zero-width spans")
    return AlignmentQuality(False, null_frac, pile_frac)


def redistribute_collapsed_words(
    words: Sequence[WordTimestamp],
    frame_duration: float,
    speech_regions: Optional[Sequence[Tuple[float, float]]] = None,
) -> List[WordTimestamp]:
    """Re-spread words: VAD-guided across speech regions when available,
    else proportionally by character count over the frame."""
    words = list(words)
    if not words:
        return []
    total_chars = sum(max(len(w.word), 1) for w in words)

    if speech_regions:
        regions = [(a, b) for a, b in speech_regions if b > a]
    else:
        regions = []
    if not regions:
        regions = [(0.0, frame_duration)]
    total_speech = sum(b - a for a, b in regions)

    out: List[WordTimestamp] = []
    consumed = 0.0   # fraction of total char mass consumed
    for w in words:
        frac = max(len(w.word), 1) / total_chars
        t0 = consumed * total_speech
        t1 = (consumed + frac) * total_speech
        out.append(WordTimestamp(w.word, _map_time(t0, regions),
                                 _map_time(t1, regions), w.prob))
        consumed += frac
    return out


def _map_time(speech_time: float,
              regions: Sequence[Tuple[float, float]]) -> float:
    """Map cumulative speech-time offset into real time across regions."""
    remaining = speech_time
    for a, b in regions:
        span = b - a
        if remaining <= span:
            return a + remaining
        remaining -= span
    return regions[-1][1]
