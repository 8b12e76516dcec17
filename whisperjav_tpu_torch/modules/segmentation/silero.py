"""Silero-style speech segmentation backend (calibrated probabilities).

The port's copy of ``whisperjav_tpu/modules/segmentation/silero_jax.py``
without the Silero network: a weights path raises "not ported yet", and
frame probabilities come from the calibrated energy sigmoid alone, the
flagless path's source.

Behavioral counterpart of the reference's Silero backends (reference:
whisperjav/modules/speech_segmentation/backends/silero.py:53-96,325 and
backends/silero_v6.py — frame probabilities → dual-threshold hysteresis
(release = threshold − 0.15), min-speech/min-silence duration filters,
sample padding 11200 pre / 20800 post @16 kHz with overlap prevention,
max-speech force-split, gap/duration grouping).

Probability source: a calibrated energy→probability sigmoid, so
threshold presets (0.41/0.28/0.18) drive identical downstream machinery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.energy import frame_energies_db
from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechSegment, group_segments, pad_segments,
)


@dataclass
class SileroJaxConfig:
    threshold: float = 0.28
    hysteresis_offset: float = 0.15      # release = threshold − offset
    min_speech_duration_ms: float = 200.0
    min_silence_duration_ms: float = 300.0
    max_speech_duration_s: float = 25.0  # force-split cap (v6 semantics)
    pad_start_s: float = 0.7             # ≈11200 samples @16 kHz
    pad_end_s: float = 1.3               # ≈20800 samples @16 kHz
    max_group_duration_s: float = 6.0
    max_group_gap_s: float = 2.0
    weights: Optional[str] = None        # the Silero network: not ported
    frame_s: float = 0.04


def hysteresis_regions(probs: np.ndarray, frame_s: float, onset: float,
                       release: float) -> List[SpeechSegment]:
    """Dual-threshold state machine over frame probabilities (native C++
    scan when built; multi-hour prob tracks stay cheap)."""
    from whisperjav_tpu_torch import native
    regions = native.hysteresis(np.asarray(probs, np.float32),
                                onset, release)
    return [SpeechSegment(a * frame_s, b * frame_s) for a, b in regions]


class SileroJaxSegmenter:
    name = "silero-jax"

    def __init__(self, **kwargs):
        self.config = SileroJaxConfig(**kwargs)
        if self.config.weights:
            raise NotImplementedError(
                "not ported yet: the Silero network (weights=...)")

    # ------------------------------------------------------------------
    def frame_probs(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        cfg = self.config
        # calibrated energy fallback: sigmoid centered so the preset
        # thresholds land at sensible dB levels (p=0.5 at 38 dB, ~6 dB/σ)
        frame_ms = cfg.frame_s * 1000.0
        db = frame_energies_db(audio, sample_rate, frame_ms)
        return (1.0 / (1.0 + np.exp(-(db - 38.0) / 6.0))).astype(np.float32)

    # ------------------------------------------------------------------
    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        cfg = self.config
        duration = len(audio) / sample_rate
        probs = self.frame_probs(audio, sample_rate)
        onset = cfg.threshold
        release = max(0.01, cfg.threshold - cfg.hysteresis_offset)
        segments = hysteresis_regions(probs, cfg.frame_s, onset, release)

        # min-duration filters
        min_speech = cfg.min_speech_duration_ms / 1000.0
        segments = [s for s in segments if s.duration >= min_speech]
        # merge neighbors separated by < min_silence
        min_sil = cfg.min_silence_duration_ms / 1000.0
        merged: List[SpeechSegment] = []
        for s in segments:
            if merged and s.start - merged[-1].end < min_sil:
                merged[-1] = SpeechSegment(merged[-1].start, s.end,
                                           max(merged[-1].prob, s.prob))
            else:
                merged.append(s)
        # force-split overlong speech (v6 max_speech_duration_s semantics)
        split: List[SpeechSegment] = []
        for s in merged:
            if s.duration <= cfg.max_speech_duration_s:
                split.append(s)
            else:
                n = int(np.ceil(s.duration / cfg.max_speech_duration_s))
                step = s.duration / n
                for i in range(n):
                    split.append(SpeechSegment(s.start + i * step,
                                               s.start + (i + 1) * step,
                                               s.prob))
        padded = pad_segments(split, duration, cfg.pad_start_s, cfg.pad_end_s)
        groups = group_segments(padded, cfg.max_group_duration_s,
                                cfg.max_group_gap_s)
        return SegmentationResult(
            padded, groups, self.name, duration,
            {"num_segments": len(padded), "num_groups": len(groups),
             "model": "energy-prob"})
