"""Silero-based scene detection: energy chapters + VAD-refined chunks.

The port's copy of ``whisperjav_tpu/modules/scene_detection/
silero_scene.py``. Behavioral counterpart of the reference's Silero
scene backend (reference: whisperjav/modules/scene_detection_backends/
silero_backend.py:51-188 — subclasses the auditok detector, replacing
pass 2 with Silero VAD regions). Pass 1 reuses the energy chapter split
and pass 2 packs silero VAD regions (the network on ``device`` when
``vad_weights`` is given) into ≤ max_scene_duration scenes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.base import (
    Scene, SceneDetectionResult,
)
from whisperjav_tpu_torch.modules.scene_detection.energy import (
    EnergySceneConfig, EnergySceneDetector,
)


@dataclass
class SileroSceneConfig(EnergySceneConfig):
    vad_threshold: float = 0.28
    vad_weights: Optional[str] = None


class SileroSceneDetector(EnergySceneDetector):
    name = "silero-scene"

    def __init__(self, device="cuda", **kwargs):
        self.config = SileroSceneConfig(**kwargs)
        from whisperjav_tpu_torch.modules.segmentation.silero import (
            SileroJaxSegmenter,
        )
        self._vad = SileroJaxSegmenter(
            device=device, threshold=self.config.vad_threshold,
            weights=self.config.vad_weights,
            max_group_duration_s=self.config.max_scene_duration_s,
            max_group_gap_s=self.config.chunk_max_silence_s * 4,
        )

    def detect(self, audio: np.ndarray, sample_rate: int) -> SceneDetectionResult:
        """Pass 1: energy CHAPTER split (long-silence boundaries only);
        pass 2: silero-jax VAD groups chunk long chapters to scene size.

        Note: refinement must run on the coarse chapters — the inherited
        detect() already chunks everything to ≤ max_scene_duration_s, which
        would leave the VAD with nothing to do."""
        from whisperjav_tpu_torch.modules.scene_detection.energy import (
            _active_regions, frame_energies_db,
        )
        cfg = self.config
        total = len(audio) / sample_rate
        energies = frame_energies_db(audio, sample_rate, cfg.frame_ms)
        frame_s = cfg.frame_ms / 1000.0
        chapters = _active_regions(
            energies >= cfg.chapter_energy_db, frame_s,
            cfg.chapter_max_silence_s, cfg.min_scene_duration_s,
            cfg.chapter_max_duration_s)
        if not chapters and total > 0:
            chapters = [(0.0, total)]

        refined = 0
        scenes: List[Scene] = []
        for ch_start, ch_end in chapters:
            if ch_end - ch_start <= cfg.max_scene_duration_s:
                scenes.append(Scene(len(scenes), ch_start, ch_end))
                continue
            a = int(ch_start * sample_rate)
            b = int(ch_end * sample_rate)
            seg = self._vad.segment(audio[a:b], sample_rate)
            if not seg.groups:
                scenes.append(Scene(len(scenes), ch_start, ch_end))
                continue
            refined += 1
            for g in seg.groups:
                scenes.append(Scene(len(scenes), ch_start + g.start,
                                    ch_start + g.end))
        for i, sc in enumerate(scenes):
            sc.index = i
        return SceneDetectionResult(
            scenes, total, self.name,
            {"chapters": len(chapters), "scenes": len(scenes),
             "vad_refined_chapters": refined})
