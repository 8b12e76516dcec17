"""Semantic scene detection: MFCC texture clustering (host-side).

Behavioral counterpart of the reference's semantic backend
(reference: whisperjav/modules/scene_detection_backends/semantic_backend.py
:24 and vendor/semantic_audio_clustering.py:393-576 — single-pass MFCC
texture clustering with agglomerative cosine linkage, snap-to-silence
boundary refinement, smart merge to full timeline coverage, 20–420 s
scenes, and a scene-type classifier that emits ASR prompt hints).

The port's copy of ``whisperjav_tpu/modules/scene_detection/semantic.py``:
MFCCs come from the Slaney mel filterbank + DCT-II (no librosa), texture
features are per-second mean/std vectors. The clustering runs on
``scipy.cluster.hierarchy`` (the JAX package calls scikit-learn's
``AgglomerativeClustering``, which builds the same average-linkage
cosine tree with scipy when it has no connectivity and merges while the
linkage distance is below ``distance_threshold``): the tree is cut just
below the threshold, so a merge at exactly the threshold stays unmade,
as in scikit-learn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
from scipy.fftpack import dct

from whisperjav_tpu_torch.modules.scene_detection.base import (
    Scene, SceneDetectionResult,
)
from whisperjav_tpu_torch.modules.scene_detection.energy import frame_energies_db
from whisperjav_tpu_torch.ops.mel import mel_filterbank
from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class SemanticSceneConfig:
    n_mfcc: int = 13
    texture_window_s: float = 1.0
    min_scene_s: float = 20.0
    max_scene_s: float = 420.0
    distance_threshold: float = 0.7      # cosine distance on z-scored textures
    snap_radius_s: float = 1.0           # boundary snap-to-silence search
    silence_db: float = 34.0


def compute_mfcc(audio: np.ndarray, sample_rate: int,
                 n_mfcc: int = 13, n_fft: int = 400,
                 hop: int = 160) -> np.ndarray:
    """(frames, n_mfcc) MFCCs via our mel filterbank + DCT-II ortho.

    Single-precision, chunked, zero-copy framing: stride-tricks views of
    the audio, a float32 window and a float32 FFT in chunks of 16384
    frames, so temporary memory stays small on long files."""
    n = (len(audio) - n_fft) // hop + 1
    if n <= 0:
        return np.zeros((0, n_mfcc), np.float32)
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    fbank = mel_filterbank(40, n_fft // 2 + 1, sample_rate).T.astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(audio, n_fft)[::hop][:n]
    mel = np.empty((n, fbank.shape[1]), np.float32)
    chunk = 16384
    for i in range(0, n, chunk):
        seg = frames[i:i + chunk] * win          # f32 copy, ~26 MB max
        spec = np.abs(np.fft.rfft(seg, axis=1))  # complex64 → float32
        np.square(spec, out=spec)
        mel[i:i + chunk] = spec @ fbank
    logmel = np.log10(np.maximum(mel, 1e-10))
    return dct(logmel, type=2, axis=1, norm="ortho")[:, :n_mfcc].astype(np.float32)


def texture_features(mfcc: np.ndarray, frames_per_window: int) -> np.ndarray:
    """Per-window mean‖std texture vectors."""
    n_win = len(mfcc) // frames_per_window
    if n_win == 0:
        return np.zeros((0, mfcc.shape[1] * 2), np.float32)
    m = mfcc[: n_win * frames_per_window].reshape(n_win, frames_per_window, -1)
    return np.concatenate([m.mean(axis=1), m.std(axis=1)], axis=1)


class SemanticSceneDetector:
    name = "semantic"

    def __init__(self, **kwargs):
        self.config = SemanticSceneConfig(**kwargs)

    # ------------------------------------------------------------------
    def _cluster_boundaries(self, feats: np.ndarray) -> List[int]:
        """Window indices where the cluster label changes."""
        from scipy.cluster.hierarchy import fcluster, linkage
        if len(feats) < 4:
            return []
        # z-score each feature dimension: raw MFCC textures are dominated by
        # c0 energy, which collapses cosine distances to ~0
        mu = feats.mean(axis=0, keepdims=True)
        sd = feats.std(axis=0, keepdims=True) + 1e-6
        z = (feats - mu) / sd
        tree = linkage(z, method="average", metric="cosine")
        # merges at distances strictly below the threshold
        cut = np.nextafter(self.config.distance_threshold, -np.inf)
        labels = fcluster(tree, t=cut, criterion="distance")
        return [i for i in range(1, len(labels)) if labels[i] != labels[i - 1]]

    def _snap_to_silence(self, t: float, energies: np.ndarray,
                         frame_s: float, total: float) -> float:
        """Move a boundary to the quietest frame within ±snap_radius."""
        cfg = self.config
        lo = max(0, int((t - cfg.snap_radius_s) / frame_s))
        hi = min(len(energies), int((t + cfg.snap_radius_s) / frame_s))
        if hi <= lo:
            return t
        local = energies[lo:hi]
        return float(np.clip((lo + int(np.argmin(local))) * frame_s,
                             0.0, total))

    # ------------------------------------------------------------------
    def detect(self, audio: np.ndarray, sample_rate: int) -> SceneDetectionResult:
        cfg = self.config
        total = len(audio) / sample_rate
        if total < cfg.min_scene_s:
            scenes = [Scene(0, 0.0, total)] if total > 0 else []
            return SceneDetectionResult(scenes, total, self.name,
                                        {"scenes": len(scenes)})

        mfcc = compute_mfcc(audio, sample_rate, cfg.n_mfcc)
        frames_per_window = int(cfg.texture_window_s / 0.01)
        feats = texture_features(mfcc, frames_per_window)
        change_windows = self._cluster_boundaries(feats)

        energies = frame_energies_db(audio, sample_rate, 10.0)
        frame_s = 0.01
        boundaries = [0.0]
        for w in change_windows:
            t = w * cfg.texture_window_s
            t = self._snap_to_silence(t, energies, frame_s, total)
            if t - boundaries[-1] >= cfg.min_scene_s:
                boundaries.append(t)
        boundaries.append(total)
        # merge a too-short tail into the previous scene
        if len(boundaries) >= 3 and boundaries[-1] - boundaries[-2] < cfg.min_scene_s:
            boundaries.pop(-2)

        scenes: List[Scene] = []
        for a, b in zip(boundaries[:-1], boundaries[1:]):
            # split over-long scenes evenly (max_scene cap)
            if b - a > cfg.max_scene_s:
                n_parts = int(np.ceil((b - a) / cfg.max_scene_s))
                step = (b - a) / n_parts
                for i in range(n_parts):
                    scenes.append(Scene(len(scenes), a + i * step,
                                        a + (i + 1) * step))
            else:
                scenes.append(Scene(len(scenes), a, b))

        for sc in scenes:
            sc.scene_type = self._classify(audio, sample_rate, sc)
        stats = {"scenes": len(scenes),
                 "texture_windows": len(feats),
                 "cluster_changes": len(change_windows)}
        logger.debug("semantic scenes: %d (%d texture changes)",
                     len(scenes), len(change_windows))
        return SceneDetectionResult(scenes, total, self.name, stats)

    # ------------------------------------------------------------------
    def _classify(self, audio: np.ndarray, sample_rate: int,
                  scene: Scene) -> str:
        """Coarse scene type → downstream ASR prompt hint (reference:
        vendor AdaptiveClassifier emits prompts per scene type)."""
        a = int(scene.start * sample_rate)
        b = int(scene.end * sample_rate)
        clip = audio[a:b]
        if len(clip) < sample_rate:
            return "unknown"
        e = frame_energies_db(clip, sample_rate, 10.0)
        active = (e > 35.0).mean()
        var = float(np.var(e))
        if active > 0.8 and var < 40.0:
            return "continuous"      # music / dense speech
        if active < 0.25:
            return "sparse"          # mostly silence / ambience
        return "dialogue"
