"""WhisperSeg segmentation backend: windowed model probs + hysteresis.

The port's copy of ``whisperjav_tpu/modules/segmentation/whisperseg.py``.
Post-chain parity with the reference's WhisperSeg backend (reference:
whisperjav/modules/speech_segmentation/backends/whisperseg.py:57-130 —
30 s windows → 1500 frames @20 ms, sigmoid probs → dual-threshold
hysteresis with release = threshold − 0.15, min-duration filters,
padding, grouping). With ``weights`` (a ``.npz`` in the JAX package's
layout) the network (``models/vad/whisperseg.py``: Whisper-base encoder
+ 2-layer decoder + (1, d) frame head) scores batches of 30 s windows on
``device`` (bf16 on the card, f32 on the CPU); without weights the
calibrated energy probability (the silero backend's source) runs at
20 ms frames.
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
from whisperjav_tpu_torch.ops.mel import N_SAMPLES
from whisperjav_tpu_torch.utils.logger import logger


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

    def __init__(self, device="cuda", **kwargs):
        self.config = WhisperSegConfig(**kwargs)
        self.device = device
        self._net = None
        if self.config.weights:
            import torch
            from whisperjav_tpu_torch.models.vad import whisperseg
            from whisperjav_tpu_torch.pipelines.engine import resolve_device
            self.device = resolve_device(device)
            # Kernel A takes bf16: on the card the network runs in bf16
            dtype = (torch.bfloat16 if self.device.type == "cuda"
                     else torch.float32)
            self._net = whisperseg.load_params(
                self.config.weights, dtype=dtype, device=self.device)
            logger.info("whisperseg: loaded weights from %s",
                        self.config.weights)

    # ------------------------------------------------------------------
    def frame_probs(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        if self._net is None:
            db = frame_energies_db(audio, sample_rate, self.FRAME_S * 1000.0)
            return (1.0 / (1.0 + np.exp(-(db - 38.0) / 6.0))).astype(np.float32)

        import torch
        from whisperjav_tpu_torch.models.vad import whisperseg
        n_frames_total = int(len(audio) / sample_rate / self.FRAME_S)
        # windowed batched inference over 30 s chunks
        chunks = []
        for a in range(0, len(audio), N_SAMPLES):
            clip = audio[a:a + N_SAMPLES]
            if len(clip) < N_SAMPLES:
                clip = np.pad(clip, (0, N_SAMPLES - len(clip)))
            chunks.append(clip)
        probs = []
        bs = self.config.batch_size
        for i in range(0, len(chunks), bs):
            batch = np.stack(chunks[i:i + bs]).astype(np.float32)
            if batch.shape[0] < bs:   # one batch shape for every call
                batch = np.pad(batch, ((0, bs - batch.shape[0]), (0, 0)))
            p = whisperseg.probs(self._net,
                                 torch.from_numpy(batch).to(self.device))
            probs.append(p.cpu().numpy()[:len(chunks[i:i + bs])])
        flat = np.concatenate(probs, axis=0).reshape(-1)
        return flat[:n_frames_total]

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
             "model": ("network" if self._net is not None
                       else "energy-prob")})
