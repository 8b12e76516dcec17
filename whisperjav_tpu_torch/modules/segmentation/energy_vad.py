"""Energy VAD backend + null (full-clip) segmenter.

The energy VAD is the dependency-free baseline backend (the reference's
cheapest analogue is using auditok at fine resolution); the null segmenter
mirrors the reference's "none" backend → full-clip transcription path
(reference: whisperjav/modules/speech_segmentation/backends/none.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.energy import frame_energies_db
from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechGroup, SpeechSegment, group_segments,
    merge_close_segments, pad_segments,
)


@dataclass
class EnergyVadConfig:
    energy_db: float = 40.0
    min_speech_s: float = 0.15
    max_silence_s: float = 0.25
    min_gap_merge_s: float = 0.3
    pad_start_s: float = 0.2
    pad_end_s: float = 0.4
    max_group_duration_s: float = 29.0
    max_group_gap_s: float = 2.0
    frame_ms: float = 10.0


class EnergySpeechSegmenter:
    name = "energy"

    def __init__(self, **kwargs):
        self.config = EnergyVadConfig(**kwargs)

    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        cfg = self.config
        duration = len(audio) / sample_rate
        energies = frame_energies_db(audio, sample_rate, cfg.frame_ms)
        frame_s = cfg.frame_ms / 1000.0
        active = energies >= cfg.energy_db

        segments: List[SpeechSegment] = []
        if active.any():
            idx = np.flatnonzero(active)
            gaps = np.diff(idx)
            max_sil = int(round(cfg.max_silence_s / frame_s))
            breaks = np.flatnonzero(gaps > max_sil + 1)
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks, [len(idx) - 1]])
            for s, e in zip(starts, ends):
                st, en = idx[s] * frame_s, (idx[e] + 1) * frame_s
                if en - st >= cfg.min_speech_s:
                    segments.append(SpeechSegment(st, en))

        segments = merge_close_segments(segments, cfg.min_gap_merge_s)
        segments = pad_segments(segments, duration, cfg.pad_start_s,
                                cfg.pad_end_s)
        groups = group_segments(segments, cfg.max_group_duration_s,
                                cfg.max_group_gap_s)
        return SegmentationResult(segments, groups, self.name, duration,
                                  {"num_segments": len(segments),
                                   "num_groups": len(groups)})


class NullSegmenter:
    """Full-clip transcription: one segment/group spanning the audio."""

    name = "none"

    def __init__(self, max_group_duration_s: float = 29.0, **_):
        self.max_group_duration_s = max_group_duration_s

    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        duration = len(audio) / sample_rate
        if duration <= 0:
            return SegmentationResult([], [], self.name, 0.0)
        seg = SpeechSegment(0.0, duration)
        groups = group_segments([seg], self.max_group_duration_s)
        return SegmentationResult([seg], groups, self.name, duration)


def vad_failover_check(result: SegmentationResult,
                       min_coverage: float = 0.03,
                       min_duration_s: float = 30.0) -> bool:
    """True when VAD coverage is implausibly low and the pipeline should
    force full-clip transcription (reference: whisperjav/modules/
    vad_failover.py used at faster_whisper_pro_asr.py:527-545)."""
    if result.audio_duration < min_duration_s:
        return False
    return result.speech_coverage < min_coverage
