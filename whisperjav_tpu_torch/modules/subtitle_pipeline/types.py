"""Decoupled subtitle pipeline data model.

Parity with the reference's types (reference: whisperjav/modules/
subtitle_pipeline/types.py:117-233 — TemporalFrame/FramingResult/
TranscriptionResult/AlignmentResult/WordTimestamp, TimestampMode,
RegroupMode, StepDownConfig, HardeningConfig, SceneDiagnostics 2.0.0).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class TimestampMode(str, enum.Enum):
    """How null/collapsed timestamps are resolved during hardening
    (reference: types.py:138-160)."""
    ALIGNER_INTERPOLATION = "aligner_interpolation"
    ALIGNER_VAD_FALLBACK = "aligner_vad_fallback"
    ALIGNER_ONLY = "aligner_only"
    VAD_ONLY = "vad_only"


class RegroupMode(str, enum.Enum):
    """Reconstruction regroup flavor (reference: types.py:117-135)."""
    STANDARD = "standard"
    SENTENCE_ONLY = "sentence_only"
    OFF = "off"


@dataclass
class TemporalFrame:
    """One generator/aligner work unit inside a scene."""
    index: int
    start: float                 # seconds, scene-relative
    end: float
    speech_regions: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class FramingResult:
    frames: List[TemporalFrame]
    backend: str
    scene_duration: float
    speech_regions: List[Tuple[float, float]] = field(default_factory=list)
    # raw VAD regions kept for sentinel recovery
    # (reference: framers/vad_grouped.py:1-13)


@dataclass
class TranscriptionResult:
    frame_index: int
    text: str
    avg_logprob: float = 0.0
    raw_text: Optional[str] = None


@dataclass
class WordTimestamp:
    word: str
    start: Optional[float]       # None = alignment failed for this word
    end: Optional[float]
    prob: float = 1.0


@dataclass
class AlignmentResult:
    frame_index: int
    words: List[WordTimestamp]
    collapsed: bool = False      # sentinel verdict


@dataclass
class StepDownConfig:
    """Retry collapsed scenes at tighter framing (reference:
    orchestrator.py:162-221)."""
    enabled: bool = True
    fallback_max_group_s: float = 3.0
    max_retries: int = 1


@dataclass
class HardeningConfig:
    timestamp_mode: TimestampMode = TimestampMode.ALIGNER_VAD_FALLBACK
    min_word_duration_s: float = 0.05
    max_subtitle_duration_s: float = 12.0


@dataclass
class SceneDiagnostics:
    """Per-scene health record (reference schema 2.0.0,
    types.py:204-233)."""
    SCHEMA_VERSION = "2.0.0"
    scene_index: int = 0
    frames: int = 0
    generated_chars: int = 0
    aligned_words: int = 0
    null_timestamp_words: int = 0
    collapsed_frames: int = 0
    step_down_retries: int = 0
    hardening_actions: int = 0
    elapsed_s: float = 0.0
    # per-step wall clocks (frame/generate/clean/align/assemble) so
    # file-level runs can attribute where scene time goes — the
    # generate-loop RTF alone says nothing about the whole decoupled
    # path (reference whole-path: qwen_pipeline.py:530-1056)
    stage_s: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = {"schema_version": self.SCHEMA_VERSION}
        d.update({k: v for k, v in self.__dict__.items()})
        return d
