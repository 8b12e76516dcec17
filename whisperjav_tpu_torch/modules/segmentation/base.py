"""Speech segmentation (VAD) framework: segments, padding, grouping, factory.

Role parity with the reference's speech_segmentation package
(reference: whisperjav/modules/speech_segmentation/base.py:98-203 —
``SpeechSegment``/``SegmentationResult`` with grouping to the ASR window,
factory with lazy backends at speech_segmentation/factory.py:425-492, and
the shared pad/merge/group post-chain at backends/ten.py:31-73).

The grouping contract is the throughput-critical invariant: every group
fits one Whisper 30 s window, so the device pipeline sees only fixed-shape
(B, 80, 3000) batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclass
class SpeechSegment:
    start: float   # seconds
    end: float
    prob: float = 1.0

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SpeechGroup:
    """A batch-decodable unit: consecutive segments within one ASR window."""
    start: float
    end: float
    segments: List[SpeechSegment] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SegmentationResult:
    segments: List[SpeechSegment]
    groups: List[SpeechGroup]
    backend: str
    audio_duration: float
    stats: Dict = field(default_factory=dict)

    @property
    def speech_coverage(self) -> float:
        if self.audio_duration <= 0:
            return 0.0
        return sum(s.duration for s in self.segments) / self.audio_duration

    def to_legacy_format(self) -> List[Dict]:
        """[{'start','end'}...] per group, reference-compatible shape."""
        return [{"start": g.start, "end": g.end} for g in self.groups]


@runtime_checkable
class SpeechSegmenter(Protocol):
    name: str

    def segment(self, audio: np.ndarray, sample_rate: int) -> SegmentationResult:
        ...


# Default paddings match the reference's empirically tuned values
# (whisperjav/modules/speech_segmentation/backends/silero.py:79-96:
# 11200 samples pre / 20800 samples post at 16 kHz).
PAD_START_S = 0.7
PAD_END_S = 1.3


def pad_segments(
    segments: Sequence[SpeechSegment],
    audio_duration: float,
    pad_start_s: float = PAD_START_S,
    pad_end_s: float = PAD_END_S,
) -> List[SpeechSegment]:
    """Expand segments by context padding with overlap prevention: when the
    padded end of one segment would cross the padded start of the next, both
    are clipped to the midpoint of the original gap."""
    if not segments:
        return []
    padded = [SpeechSegment(max(0.0, s.start - pad_start_s),
                            min(audio_duration, s.end + pad_end_s), s.prob)
              for s in segments]
    for a, b, ra, rb in zip(padded[:-1], padded[1:], segments[:-1],
                            segments[1:]):
        if a.end > b.start:
            mid = (ra.end + rb.start) / 2.0
            a.end = mid
            b.start = mid
    return padded


def merge_close_segments(segments: Sequence[SpeechSegment],
                         min_gap_s: float = 0.3) -> List[SpeechSegment]:
    """Merge segments separated by less than min_gap_s."""
    out: List[SpeechSegment] = []
    for s in segments:
        if out and s.start - out[-1].end < min_gap_s:
            out[-1] = SpeechSegment(out[-1].start, max(out[-1].end, s.end),
                                    max(out[-1].prob, s.prob))
        else:
            out.append(SpeechSegment(s.start, s.end, s.prob))
    return out


def group_segments(
    segments: Sequence[SpeechSegment],
    max_group_duration_s: float = 29.0,
    max_gap_s: float = 2.0,
) -> List[SpeechGroup]:
    """Pack consecutive segments into ASR-window-sized groups.

    A group closes when adding the next segment would exceed
    ``max_group_duration_s`` (span from group start to segment end) or when
    the gap to the next segment exceeds ``max_gap_s``. A single segment
    longer than the cap is split evenly. Mirrors the shared grouping the
    reference exports from its TEN backend (backends/ten.py:31-73).
    """
    groups: List[SpeechGroup] = []
    cur: Optional[SpeechGroup] = None
    for seg in segments:
        # split oversized single segments first
        if seg.duration > max_group_duration_s:
            if cur is not None:
                groups.append(cur)
                cur = None
            n_parts = int(np.ceil(seg.duration / max_group_duration_s))
            step = seg.duration / n_parts
            for i in range(n_parts):
                s = SpeechSegment(seg.start + i * step,
                                  seg.start + (i + 1) * step, seg.prob)
                groups.append(SpeechGroup(s.start, s.end, [s]))
            continue
        if cur is None:
            cur = SpeechGroup(seg.start, seg.end, [seg])
        elif (seg.end - cur.start <= max_group_duration_s
              and seg.start - cur.end <= max_gap_s):
            cur.end = seg.end
            cur.segments.append(seg)
        else:
            groups.append(cur)
            cur = SpeechGroup(seg.start, seg.end, [seg])
    if cur is not None:
        groups.append(cur)
    return groups


def create_segmenter(backend: str = "energy", device="cuda",
                     **kwargs) -> SpeechSegmenter:
    """Factory with lazy imports (reference:
    speech_segmentation/factory.py:425-492). The network backends (a
    ``weights`` path for silero, ten and whisperseg; whisper-vad always)
    run on ``device``. A backend that fails to build raises: the JAX
    package's fall-back to energy VAD on ``ImportError`` is not copied, so
    a requested network never turns silently into the energy
    probability."""
    from whisperjav_tpu_torch.utils.logger import logger
    backend = (backend or "energy").lower().replace("_", "-")
    if backend in ("none", "null"):
        from whisperjav_tpu_torch.modules.segmentation.energy_vad import NullSegmenter
        return NullSegmenter(**kwargs)
    if backend in ("energy", "default"):
        from whisperjav_tpu_torch.modules.segmentation.energy_vad import (
            EnergySpeechSegmenter,
        )
        return EnergySpeechSegmenter(**kwargs)
    if backend in ("ten", "ten-jax"):
        # distinct TEN-class frame VAD (models/vad/ten.py) with the
        # reference's detect→merge→pad→split-at-prob-minima→group chain
        # (reference: speech_segmentation/backends/ten.py:76-97,440-520)
        from whisperjav_tpu_torch.modules.segmentation.ten import (
            TenJaxSegmenter,
        )
        return TenJaxSegmenter(device=device, **kwargs)
    if backend in ("silero", "silero-jax", "silero-v3", "silero-v4",
                   "silero-v3.1"):
        if backend in ("silero-v3", "silero-v3.1", "silero-v4"):
            # The v3.1/v4 JIT graphs are NOT ported — only the v5/v6
            # architecture is (models/vad/silero.py; supersession
            # rationale: PARITY row 10, the reference's own F1 data
            # shows v6.2 ≥ v3.1). Users pinning a version expecting
            # reference behavior must hear about the substitution
            # loudly, not get a silent different model (reference
            # version map: backends/silero.py:79-96).
            logger.warning(
                "--vad-backend %s: the silero %s graph is not ported; "
                "substituting the silero v5/v6 architecture (F1 0.654 "
                "vs v3.1's 0.625 on the reference's GT protocol). "
                "Pass --vad-backend silero to silence this warning.",
                backend, backend.split("-", 1)[1])
        from whisperjav_tpu_torch.modules.segmentation.silero import (
            SileroJaxSegmenter,
        )
        return SileroJaxSegmenter(device=device, **kwargs)
    if backend in ("whisper-vad", "whispervad"):
        from whisperjav_tpu_torch.modules.segmentation.whisper_vad import (
            WhisperVadSegmenter,
        )
        return WhisperVadSegmenter(device=device, **kwargs)
    if backend == "whisperseg":
        from whisperjav_tpu_torch.modules.segmentation.whisperseg import (
            WhisperSegSegmenter,
        )
        return WhisperSegSegmenter(device=device, **kwargs)
    logger.warning("unknown segmenter backend %r; using energy", backend)
    from whisperjav_tpu_torch.modules.segmentation.energy_vad import (
        EnergySpeechSegmenter,
    )
    return EnergySpeechSegmenter(**kwargs)
