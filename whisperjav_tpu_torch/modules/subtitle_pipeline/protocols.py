"""Runtime-checkable protocols for the decoupled pipeline components.

Parity with reference ``whisperjav/modules/subtitle_pipeline/protocols.py
:29-139`` (TemporalFramer/TextGenerator/TextCleaner/TextAligner). The
reference's load()/unload() VRAM-swap methods are retained as hooks:
the port's generator and aligner load their weights onto the device in
load() and drop them in unload() (reference: orchestrator.py:16-21
documents the swap).
"""

from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

import numpy as np

from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    AlignmentResult, FramingResult, TranscriptionResult,
)


@runtime_checkable
class TemporalFramer(Protocol):
    name: str

    def frame(self, audio: np.ndarray, sample_rate: int,
              max_group_s: float) -> FramingResult: ...


@runtime_checkable
class TextGenerator(Protocol):
    name: str

    def load(self) -> None: ...

    def unload(self) -> None: ...

    def generate_batch(
        self, clips: Sequence[np.ndarray], sample_rate: int,
    ) -> List[TranscriptionResult]: ...


@runtime_checkable
class TextCleaner(Protocol):
    name: str

    def clean_batch(
        self, results: Sequence[TranscriptionResult],
    ) -> List[TranscriptionResult]: ...


@runtime_checkable
class TextAligner(Protocol):
    name: str

    def load(self) -> None: ...

    def unload(self) -> None: ...

    def align_batch(
        self, clips: Sequence[np.ndarray], sample_rate: int,
        texts: Sequence[str],
    ) -> List[AlignmentResult]: ...
