"""WhisperSeg segmentation backend: frame probabilities + hysteresis.

The port's copy of ``whisperjav_tpu/modules/segmentation/whisperseg.py``
on the path that runs without weights: the calibrated energy
probability (the silero backend's source) at 20 ms frames, then the
reference's post-chain (reference: whisperjav/modules/
speech_segmentation/backends/whisperseg.py:57-130 — dual-threshold
hysteresis with release = threshold − 0.15, min-duration filters,
padding, grouping). The WhisperSeg network (``weights=...``) is not
ported yet and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.energy import frame_energies_db
from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechSegment, group_segments, pad_segments,
)
from whisperjav_tpu_torch.modules.segmentation.silero import hysteresis_regions


@dataclass
class WhisperSegConfig:
    threshold: float = 0.5
    hysteresis_offset: float = 0.15
    min_speech_duration_ms: float = 150.0
    min_silence_duration_ms: float = 250.0
    pad_start_s: float = 0.25
    pad_end_s: float = 0.5
    max_group_duration_s: float = 6.0
    max_group_gap_s: float = 2.0
    weights: Optional[str] = None
    batch_size: int = 4


class WhisperSegSegmenter:
    name = "whisperseg"

    FRAME_S = 0.02

    def __init__(self, **kwargs):
        self.config = WhisperSegConfig(**kwargs)
        if self.config.weights:
            raise NotImplementedError(
                "not ported yet: the WhisperSeg network (whisperseg "
                "weights=...); without weights the energy probability "
                "runs")

    # ------------------------------------------------------------------
    def frame_probs(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        db = frame_energies_db(audio, sample_rate, self.FRAME_S * 1000.0)
        return (1.0 / (1.0 + np.exp(-(db - 38.0) / 6.0))).astype(np.float32)

    # ------------------------------------------------------------------
    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        cfg = self.config
        duration = len(audio) / sample_rate
        probs = self.frame_probs(audio, sample_rate)
        release = max(0.01, cfg.threshold - cfg.hysteresis_offset)
        segments = hysteresis_regions(probs, self.FRAME_S, cfg.threshold,
                                      release)
        min_speech = cfg.min_speech_duration_ms / 1000.0
        segments = [s for s in segments if s.duration >= min_speech]
        min_sil = cfg.min_silence_duration_ms / 1000.0
        merged: List[SpeechSegment] = []
        for s in segments:
            if merged and s.start - merged[-1].end < min_sil:
                merged[-1] = SpeechSegment(merged[-1].start, s.end,
                                           max(merged[-1].prob, s.prob))
            else:
                merged.append(s)
        padded = pad_segments(merged, duration, cfg.pad_start_s,
                              cfg.pad_end_s)
        groups = group_segments(padded, cfg.max_group_duration_s,
                                cfg.max_group_gap_s)
        return SegmentationResult(
            padded, groups, self.name, duration,
            {"num_segments": len(padded), "num_groups": len(groups),
             "model": "energy-prob"})
