"""Scene detection framework: split long-form audio into scenes.

Role parity with the reference's scene-detection backend framework
(reference: whisperjav/modules/scene_detection_backends/base.py:186-251 —
Protocol + two-pass coarse-chapters → fine-chunks paradigm, factory with
fallback). Scene detection stays host-side numpy: it is cheap, IO-bound,
and feeds the device batching queue (SURVEY.md §7 layer 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np


@dataclass
class Scene:
    index: int
    start: float          # seconds in source audio
    end: float
    scene_type: str = "speech"   # speech | mixed | unknown
    metadata: Dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SceneDetectionResult:
    scenes: List[Scene]
    total_duration: float
    backend: str
    stats: Dict = field(default_factory=dict)

    def to_legacy_tuples(self) -> List[tuple]:
        """(start_s, end_s, duration_s) triples, reference-compatible."""
        return [(s.start, s.end, s.duration) for s in self.scenes]


@runtime_checkable
class SceneDetector(Protocol):
    name: str

    def detect(self, audio: np.ndarray, sample_rate: int) -> SceneDetectionResult:
        ...


def create_scene_detector(backend: str = "energy", device="cuda",
                          **kwargs) -> SceneDetector:
    """Factory mirroring SceneDetectorFactory.create/safe_create semantics
    (reference: scene_detection_backends/factory.py:190-309): unknown
    backends fall back to the energy detector with a warning.
    The silero detector's VAD network (``vad_weights``) runs on
    ``device``.
    """
    from whisperjav_tpu_torch.utils.logger import logger
    backend = (backend or "energy").lower()
    if backend in ("none", "null"):
        from whisperjav_tpu_torch.modules.scene_detection.energy import NullSceneDetector
        return NullSceneDetector()
    if backend in ("energy", "auditok", "default"):
        from whisperjav_tpu_torch.modules.scene_detection.energy import EnergySceneDetector
        return EnergySceneDetector(**kwargs)
    if backend == "semantic":
        from whisperjav_tpu_torch.modules.scene_detection.semantic import (
            SemanticSceneDetector,
        )
        return SemanticSceneDetector(**kwargs)
    if backend in ("silero", "silero-scene"):
        from whisperjav_tpu_torch.modules.scene_detection.silero_scene import (
            SileroSceneDetector,
        )
        return SileroSceneDetector(device=device, **kwargs)
    logger.warning("unknown scene backend %r; falling back to energy", backend)
    from whisperjav_tpu_torch.modules.scene_detection.energy import EnergySceneDetector
    return EnergySceneDetector(**kwargs)
