"""Energy-based two-pass scene detection (vectorized numpy).

Behavioral counterpart of the reference's auditok backend
(reference: whisperjav/modules/scene_detection_backends/auditok_backend.py:
36-93 — pass 1 splits on long silences into coarse chapters, pass 2 chunks
chapters to ≤ max_scene_duration with a stricter energy threshold, with a
brute-force fallback split), re-implemented from scratch as array ops:
frame energies are computed once and both passes are hysteresis runs over
the same energy track at different thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.base import (
    Scene, SceneDetectionResult,
)
from whisperjav_tpu_torch.utils.logger import logger

_EPS = 1e-12


@dataclass
class EnergySceneConfig:
    # pass 1: coarse chapters split on long silences
    chapter_energy_db: float = 32.0      # int16-referenced dB (auditok scale)
    chapter_max_silence_s: float = 1.8
    chapter_max_duration_s: float = 2700.0
    # pass 2: chunking to ASR-window-sized scenes
    chunk_energy_db: float = 38.0
    chunk_max_silence_s: float = 0.4
    max_scene_duration_s: float = 29.0
    min_scene_duration_s: float = 0.2
    frame_ms: float = 10.0


def frame_energies_db(audio: np.ndarray, sample_rate: int,
                      frame_ms: float = 10.0) -> np.ndarray:
    """Per-frame energy in auditok-style dB: 10*log10(mean(int16_x²)).

    Uses the native C++ kernel when built (multi-hour files stream
    without the float64 numpy temporary), numpy otherwise.
    """
    hop = max(1, int(sample_rate * frame_ms / 1000.0))
    from whisperjav_tpu_torch import native
    return native.frame_energy_db(np.asarray(audio, np.float32), hop)


def _active_regions(active: np.ndarray, frame_s: float,
                    max_silence_s: float, min_dur_s: float,
                    max_dur_s: float) -> List[Tuple[float, float]]:
    """Merge boolean frame activity into regions, tolerating short silences.

    A region absorbs interior silence runs up to max_silence_s; regions
    longer than max_dur_s are split at that bound.
    """
    if active.size == 0 or not active.any():
        return []
    max_sil = int(round(max_silence_s / frame_s))
    # indices of active frames
    idx = np.flatnonzero(active)
    # split where gap between consecutive active frames exceeds max_sil
    gaps = np.diff(idx)
    breaks = np.flatnonzero(gaps > max_sil + 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [len(idx) - 1]])
    regions = []
    for s, e in zip(starts, ends):
        r_start = idx[s] * frame_s
        r_end = (idx[e] + 1) * frame_s
        # enforce max duration by even splitting
        dur = r_end - r_start
        if dur <= max_dur_s:
            if dur >= min_dur_s:
                regions.append((r_start, r_end))
        else:
            n_parts = int(np.ceil(dur / max_dur_s))
            step = dur / n_parts
            for i in range(n_parts):
                regions.append((r_start + i * step, r_start + (i + 1) * step))
    return regions


class EnergySceneDetector:
    name = "energy"

    def __init__(self, **kwargs):
        self.config = EnergySceneConfig(**kwargs)

    def detect(self, audio: np.ndarray, sample_rate: int) -> SceneDetectionResult:
        cfg = self.config
        total = len(audio) / sample_rate
        energies = frame_energies_db(audio, sample_rate, cfg.frame_ms)
        frame_s = cfg.frame_ms / 1000.0

        # ---- pass 1: coarse chapters on long silences ----
        chapters = _active_regions(
            energies >= cfg.chapter_energy_db, frame_s,
            cfg.chapter_max_silence_s, cfg.min_scene_duration_s,
            cfg.chapter_max_duration_s)
        if not chapters and total > 0:
            # silent-ish file: treat whole file as one chapter so the ASR
            # still gets a chance (parity with SafeSceneDetector fallback)
            chapters = [(0.0, total)]

        # ---- pass 2: chunk chapters to ≤ max_scene_duration ----
        scenes: List[Scene] = []
        for ch_start, ch_end in chapters:
            if ch_end - ch_start <= cfg.max_scene_duration_s:
                scenes.append(Scene(len(scenes), ch_start, ch_end))
                continue
            f0 = int(ch_start / frame_s)
            f1 = int(ch_end / frame_s)
            sub = _active_regions(
                energies[f0:f1] >= cfg.chunk_energy_db, frame_s,
                cfg.chunk_max_silence_s, cfg.min_scene_duration_s,
                cfg.max_scene_duration_s)
            sub = [(ch_start + s, ch_start + e) for s, e in sub]
            if not sub:
                sub = [(ch_start, ch_end)]
            # greedy-pack consecutive sub-regions into ≤ max scenes
            packed: List[Tuple[float, float]] = []
            cur_s, cur_e = sub[0]
            for s, e in sub[1:]:
                if e - cur_s <= cfg.max_scene_duration_s:
                    cur_e = e
                else:
                    packed.append((cur_s, cur_e))
                    cur_s, cur_e = s, e
            packed.append((cur_s, cur_e))
            for s, e in packed:
                # brute-force fallback: a single unbreakable region longer
                # than the cap is split evenly
                if e - s > cfg.max_scene_duration_s:
                    n_parts = int(np.ceil((e - s) / cfg.max_scene_duration_s))
                    step = (e - s) / n_parts
                    for i in range(n_parts):
                        scenes.append(Scene(len(scenes), s + i * step,
                                            s + (i + 1) * step))
                else:
                    scenes.append(Scene(len(scenes), s, e))

        for i, sc in enumerate(scenes):
            sc.index = i
        stats = {
            "chapters": len(chapters),
            "scenes": len(scenes),
            "speech_coverage": (sum(s.duration for s in scenes) / total
                                if total else 0.0),
        }
        logger.debug("energy scene detection: %d chapters → %d scenes "
                     "(%.0f%% coverage)", len(chapters), len(scenes),
                     100 * stats["speech_coverage"])
        return SceneDetectionResult(scenes, total, self.name, stats)


class NullSceneDetector:
    """Whole file as one scene (reference 'none' backend); long files are
    split at the chapter cap so downstream stays bounded."""

    name = "none"

    def __init__(self, max_scene_duration_s: float = 29.0):
        self.max_scene_duration_s = max_scene_duration_s

    def detect(self, audio: np.ndarray, sample_rate: int) -> SceneDetectionResult:
        total = len(audio) / sample_rate
        scenes = []
        n_parts = max(1, int(np.ceil(total / self.max_scene_duration_s)))
        step = total / n_parts if n_parts else 0.0
        for i in range(n_parts):
            scenes.append(Scene(i, i * step, min((i + 1) * step, total)))
        return SceneDetectionResult(scenes, total, self.name,
                                    {"scenes": len(scenes)})
