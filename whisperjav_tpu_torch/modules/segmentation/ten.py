"""TEN-class frame-VAD segmentation backend with the TEN post-chain.

The port's copy of ``whisperjav_tpu/modules/segmentation/ten_jax.py``.
Behavioral counterpart of the reference's TEN backend (reference:
whisperjav/modules/speech_segmentation/backends/ten.py:76-97,440-520):
16 ms hop frame probabilities → raw detection → merge gaps <
min_silence → asymmetric padding (50 ms pre / 150 ms post, tuned for
whispered onsets and trailing JA particles) → **split overlong segments
at smoothed-probability minima** (even-split fallback) → grouping.

Probability source: the TEN-class network (``models/vad/ten.py``) on
``device`` when a weights path is given; otherwise the calibrated
energy→probability mapping at 16 ms resolution, so the threshold preset
(0.26) drives the identical post-chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.energy import frame_energies_db
from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechSegment, group_segments,
)
from whisperjav_tpu_torch.utils.logger import logger

FRAME_S = 0.016     # hop 256 @16 kHz


@dataclass
class TenJaxConfig:
    threshold: float = 0.26
    min_speech_duration_ms: float = 81.0
    min_silence_duration_ms: float = 100.0
    max_speech_duration_s: float = 10.0
    start_pad_ms: float = 50.0
    end_pad_ms: float = 150.0
    chunk_threshold_s: float = 1.0
    max_group_duration_s: float = 29.0
    weights: Optional[str] = None


class TenJaxSegmenter:
    name = "ten-jax"

    def __init__(self, device="cuda", **kwargs):
        kwargs.pop("frame_s", None)          # fixed by the model family
        self.config = TenJaxConfig(**kwargs)
        self.device = device
        self._net = None
        if self.config.weights:
            from whisperjav_tpu_torch.models.vad import ten
            from whisperjav_tpu_torch.pipelines.engine import resolve_device
            self.device = resolve_device(device)
            self._net = ten.load_params(self.config.weights, self.device)
            logger.info("ten-jax: loaded weights from %s",
                        self.config.weights)

    # ------------------------------------------------------------------
    def frame_probs(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        if self._net is not None:
            import torch
            from whisperjav_tpu_torch.models.vad import ten
            usable = (len(audio) // ten.HOP) * ten.HOP
            if usable == 0:
                return np.zeros((0,), np.float32)
            x = torch.from_numpy(np.ascontiguousarray(
                audio[None, :usable], np.float32)).to(self.device)
            return ten.probs(self._net, x).cpu().numpy()[0]
        db = frame_energies_db(audio, sample_rate, FRAME_S * 1000.0)
        return (1.0 / (1.0 + np.exp(-(db - 38.0) / 6.0))).astype(np.float32)

    # ------------------------------------------------------------------
    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        cfg = self.config
        duration = len(audio) / sample_rate
        probs = self.frame_probs(audio, sample_rate)

        # 1. raw detection
        raw = self._detect_raw(probs)
        # 2. merge close segments
        merged = self._merge_gaps(raw)
        # 3. asymmetric padding with overlap prevention
        padded = self._pad(merged, duration)
        # 4. split overlong segments at probability minima
        split = self._split_at_minima(padded, probs)
        # 5. min-duration filter + grouping
        min_speech = cfg.min_speech_duration_ms / 1000.0
        segs = [SpeechSegment(a, b) for a, b in split if b - a >= min_speech]
        groups = group_segments(segs, cfg.max_group_duration_s,
                                cfg.chunk_threshold_s)
        return SegmentationResult(
            segs, groups, self.name, duration,
            {"num_segments": len(segs), "num_groups": len(groups),
             "model": ("network" if self._net is not None
                       else "energy-prob")})

    # ------------------------------------------------------------------
    def _detect_raw(self, probs: np.ndarray) -> List[tuple]:
        cfg = self.config
        out: List[tuple] = []
        start = None
        for i, p in enumerate(probs):
            if p >= cfg.threshold and start is None:
                start = i
            elif p < cfg.threshold and start is not None:
                out.append((start * FRAME_S, i * FRAME_S))
                start = None
            # force-split during detection
            if (start is not None
                    and (i - start) * FRAME_S >= cfg.max_speech_duration_s):
                out.append((start * FRAME_S, (i + 1) * FRAME_S))
                start = None
        if start is not None:
            out.append((start * FRAME_S, len(probs) * FRAME_S))
        return out

    def _merge_gaps(self, segs: List[tuple]) -> List[tuple]:
        min_sil = self.config.min_silence_duration_ms / 1000.0
        out: List[tuple] = []
        for a, b in segs:
            if out and a - out[-1][1] < min_sil:
                out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def _pad(self, segs: List[tuple], duration: float) -> List[tuple]:
        cfg = self.config
        pre = cfg.start_pad_ms / 1000.0
        post = cfg.end_pad_ms / 1000.0
        out: List[tuple] = []
        for i, (a, b) in enumerate(segs):
            a = max(0.0, a - pre)
            b = min(duration, b + post)
            if out and a < out[-1][1]:          # overlap prevention
                a = out[-1][1]
            if b > a:
                out.append((a, b))
        return out

    def _split_at_minima(self, segs: List[tuple],
                         probs: np.ndarray) -> List[tuple]:
        """Reference semantics (ten.py:448-515): smooth the segment's
        probability curve with a ~5% window, split at local minima spaced
        > 80% of max duration apart; even-split fallback."""
        cfg = self.config
        max_dur = cfg.max_speech_duration_s
        if max_dur <= 0:
            return segs
        out: List[tuple] = []
        for a, b in segs:
            dur = b - a
            if dur <= max_dur:
                out.append((a, b))
                continue
            i0, i1 = int(a / FRAME_S), min(int(b / FRAME_S), len(probs))
            seg_probs = probs[i0:i1]
            if len(seg_probs) < 2:
                out.extend(self._even_split(a, b, max_dur))
                continue
            window = max(3, len(seg_probs) // 20)
            smoothed = np.convolve(seg_probs,
                                   np.ones(window) / window, mode="same")
            minima = [j for j in range(1, len(smoothed) - 1)
                      if smoothed[j] <= smoothed[j - 1]
                      and smoothed[j] <= smoothed[j + 1]]
            if not minima:
                out.extend(self._even_split(a, b, max_dur))
                continue
            frame_dur = dur / len(seg_probs)
            splits: List[float] = []
            last = a
            for j in minima:
                t = a + j * frame_dur
                if t - last > max_dur * 0.8:
                    splits.append(t)
                    last = t
            if not splits:
                out.extend(self._even_split(a, b, max_dur))
                continue
            prev = a
            for t in splits:
                if t - prev > 0.05:
                    out.append((prev, t))
                    prev = t
            if b - prev > 0.05:
                out.append((prev, b))
        return out

    @staticmethod
    def _even_split(a: float, b: float, max_dur: float) -> List[tuple]:
        n = int(np.ceil((b - a) / max_dur))
        step = (b - a) / n
        return [(a + i * step, a + (i + 1) * step) for i in range(n)]
