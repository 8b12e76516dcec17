"""Timestamp hardening: resolve nulls, clamp, sort.

Parity with reference ``whisperjav/modules/subtitle_pipeline/hardening.py
:45-241`` — per TimestampMode: interpolate null-stamped words between
anchored neighbors by character length, VAD-proportional fallback,
clamping to scene duration, chronological sort.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from whisperjav_tpu_torch.modules.subtitle_pipeline.sentinel import (
    redistribute_collapsed_words,
)
from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    HardeningConfig, TimestampMode, WordTimestamp,
)


def harden_words(
    words: Sequence[WordTimestamp],
    scene_duration: float,
    config: HardeningConfig,
    speech_regions: Optional[Sequence[Tuple[float, float]]] = None,
) -> Tuple[List[WordTimestamp], int]:
    """Resolve null timestamps per the configured mode; returns
    (hardened words, number of hardening actions taken)."""
    words = [WordTimestamp(w.word, w.start, w.end, w.prob) for w in words]
    actions = 0
    mode = config.timestamp_mode

    has_null = any(w.start is None or w.end is None for w in words)
    if has_null:
        if mode == TimestampMode.VAD_ONLY:
            words = redistribute_collapsed_words(words, scene_duration,
                                                 speech_regions)
            actions += 1
        elif mode in (TimestampMode.ALIGNER_INTERPOLATION,
                      TimestampMode.ALIGNER_VAD_FALLBACK):
            words, n = _interpolate_nulls(words, scene_duration)
            actions += n
            still_null = any(w.start is None or w.end is None for w in words)
            if still_null:
                if mode == TimestampMode.ALIGNER_VAD_FALLBACK:
                    words = redistribute_collapsed_words(
                        words, scene_duration, speech_regions)
                    actions += 1
                else:
                    # interpolation-only: drop hopeless words' stamps to 0
                    words = [WordTimestamp(w.word, w.start or 0.0,
                                           w.end or (w.start or 0.0), w.prob)
                             for w in words]
                    actions += 1
        else:  # ALIGNER_ONLY: null-stamped words are dropped
            kept = [w for w in words if w.start is not None
                    and w.end is not None]
            actions += len(words) - len(kept)
            words = kept

    # clamp into the scene and enforce minimal word durations
    out: List[WordTimestamp] = []
    for w in words:
        start = min(max(w.start or 0.0, 0.0), scene_duration)
        end = min(max(w.end if w.end is not None else start, start),
                  scene_duration)
        if end - start < config.min_word_duration_s:
            end = min(start + config.min_word_duration_s, scene_duration)
            actions += 1
        out.append(WordTimestamp(w.word, start, end, w.prob))

    # chronological sort (stable) — alignment can locally invert
    ordered = sorted(out, key=lambda w: (w.start, w.end))
    if [w.word for w in ordered] != [w.word for w in out]:
        actions += 1
    return ordered, actions


def _interpolate_nulls(
    words: List[WordTimestamp], scene_duration: float,
) -> Tuple[List[WordTimestamp], int]:
    """Distribute null-stamped runs between anchored neighbors ∝ chars."""
    actions = 0
    n = len(words)
    i = 0
    while i < n:
        if words[i].start is not None and words[i].end is not None:
            i += 1
            continue
        # find the null run [i, j)
        j = i
        while j < n and (words[j].start is None or words[j].end is None):
            j += 1
        left_t = words[i - 1].end if i > 0 and words[i - 1].end is not None \
            else None
        right_t = words[j].start if j < n and words[j].start is not None \
            else None
        if left_t is None and right_t is None:
            i = j
            continue  # hopeless run; caller decides fallback
        a = left_t if left_t is not None else max(right_t - 0.5 * (j - i), 0)
        b = right_t if right_t is not None else min(
            a + 0.5 * (j - i), scene_duration)
        if b <= a:
            b = min(a + 0.05 * (j - i), scene_duration)
        chars = [max(len(words[k].word), 1) for k in range(i, j)]
        total = sum(chars)
        t = a
        for k, c in zip(range(i, j), chars):
            dur = (b - a) * c / total
            words[k] = WordTimestamp(words[k].word, t, t + dur,
                                     words[k].prob)
            t += dur
            actions += 1
        i = j
    return words, actions
