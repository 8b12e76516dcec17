"""Whisper-VAD backend: no-speech probabilities of a small Whisper as VAD.

The port's copy of ``whisperjav_tpu/modules/segmentation/whisper_vad.py``.
Behavioral counterpart of the reference's whisper_vad backend
(reference: whisperjav/modules/speech_segmentation/backends/
whisper_vad.py — runs a tiny→medium faster-whisper over windows and uses
its ``no_speech`` probabilities as voice activity). Here a small Whisper
on the port's engine (on ``device``, with the JAX segmenter's options:
cross-K/V in the compute dtype) scores 5 s sub-windows batched through
the encoder + one SOT decode step; speech probability = 1 −
P(no_speech).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechSegment, group_segments, pad_segments,
)
from whisperjav_tpu_torch.modules.segmentation.silero import hysteresis_regions


@dataclass
class WhisperVadConfig:
    model: str = "tiny"
    window_s: float = 5.0
    hop_s: float = 2.5
    threshold: float = 0.5           # speech prob = 1 - no_speech
    hysteresis_offset: float = 0.15
    pad_start_s: float = 0.3
    pad_end_s: float = 0.5
    max_group_duration_s: float = 14.0
    max_group_gap_s: float = 2.0
    checkpoint: Optional[str] = None
    batch_size: int = 16


class WhisperVadSegmenter:
    name = "whisper-vad"

    def __init__(self, engine=None, device="cuda", **kwargs):
        self.config = WhisperVadConfig(**kwargs)
        self.device = device
        self._engine = engine

    def _ensure_engine(self):
        if self._engine is None:
            from whisperjav_tpu_torch.models.whisper.decode import (
                DecodeOptions,
            )
            from whisperjav_tpu_torch.pipelines.engine import (
                QualityThresholds, TranscriptionEngine,
            )
            from whisperjav_tpu_torch.pipelines.factory import load_model
            cfg, params = load_model(self.config.model,
                                     self.config.checkpoint,
                                     device=self.device)
            self._engine = TranscriptionEngine(
                cfg, params,
                options=DecodeOptions(max_new_tokens=1,
                                      with_timestamps=False),
                thresholds=QualityThresholds(temperatures=(0.0,)),
                batch_size=self.config.batch_size, device=self.device)
        return self._engine

    # ------------------------------------------------------------------
    def window_speech_probs(self, audio: np.ndarray,
                            sample_rate: int) -> np.ndarray:
        """Sliding-window speech probabilities at hop_s resolution."""
        from whisperjav_tpu_torch.ops.mel import N_SAMPLES
        from whisperjav_tpu_torch.pipelines.engine import to_host
        cfg = self.config
        engine = self._ensure_engine()
        win = int(cfg.window_s * sample_rate)
        hop = int(cfg.hop_s * sample_rate)
        if len(audio) == 0:
            return np.zeros((0,), np.float32)
        # one window per hop interval, covering the final partial hop too
        starts = list(range(0, len(audio), hop))
        probs = np.zeros(len(starts), np.float32)
        bs = cfg.batch_size
        for i in range(0, len(starts), bs):
            chunk = starts[i:i + bs]
            buf = np.zeros((bs, N_SAMPLES), np.float32)
            for r, s in enumerate(chunk):
                clip = audio[s:s + win]
                buf[r, :len(clip)] = clip
            ns = to_host(engine.decode_batch(buf)).no_speech_prob
            probs[i:i + len(chunk)] = 1.0 - ns[:len(chunk)]
        return probs

    # ------------------------------------------------------------------
    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        cfg = self.config
        duration = len(audio) / sample_rate
        probs = self.window_speech_probs(audio, sample_rate)
        release = max(0.01, cfg.threshold - cfg.hysteresis_offset)
        segments = hysteresis_regions(probs, cfg.hop_s, cfg.threshold,
                                      release)
        segments = [SpeechSegment(s.start, min(s.end, duration), s.prob)
                    for s in segments if s.start < duration]
        padded = pad_segments(segments, duration, cfg.pad_start_s,
                              cfg.pad_end_s)
        groups = group_segments(padded, cfg.max_group_duration_s,
                                cfg.max_group_gap_s)
        return SegmentationResult(
            padded, groups, self.name, duration,
            {"num_segments": len(padded), "num_groups": len(groups),
             "windows_scored": len(probs)})
