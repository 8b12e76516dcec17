"""The file pipeline: media -> scenes -> VAD -> batched decode -> stitch ->
sanitize -> SRT, over the port's engine.

The same host orchestration as ``whisperjav_tpu/pipelines/transcribe.py``
(which imports the JAX engine). Scene detection, VAD, audio extraction,
stitching and SRT writing are the JAX package's jax-free modules, used
as they are. Speech enhancement and chunked (transformers-mode) windows
are not ported.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from whisperjav_tpu.modules.audio_extraction import AudioExtractor
from whisperjav_tpu.modules.audio_io import WHISPER_SAMPLE_RATE
from whisperjav_tpu.modules.media_discovery import MediaInfo
from whisperjav_tpu.modules.scene_detection import create_scene_detector
from whisperjav_tpu.modules.segmentation import create_segmenter
from whisperjav_tpu.modules.segmentation.energy_vad import (
    NullSegmenter, vad_failover_check,
)
from whisperjav_tpu.modules.srt import Subtitle, save_srt, stitch
from whisperjav_tpu.utils.logger import logger
from whisperjav_tpu_torch.parallel.batching import (
    Window, pack_windows, unpack_segments, windows_from_segmentation,
)
from whisperjav_tpu_torch.pipelines.engine import TranscriptionEngine


@dataclass
class PipelineResult:
    media: MediaInfo
    srt_path: Optional[Path]
    subtitles: List[Subtitle]
    metadata: Dict = field(default_factory=dict)


class TranscribePipeline:
    """Host orchestration around a :class:`TranscriptionEngine`."""

    def __init__(
        self,
        engine: TranscriptionEngine,
        scene_backend: str = "energy",
        vad_backend: str = "energy",
        scene_kwargs: Optional[Dict] = None,
        vad_kwargs: Optional[Dict] = None,
        language: str = "ja",
        postprocessor=None,          # SRTPostProcessor-compatible, optional
        pack: bool = True,           # pack short groups into shared windows
        keep_intermediates: bool = False,  # write raw pre-sanitize SRT
    ):
        self.engine = engine
        self.scene_detector = create_scene_detector(scene_backend,
                                                    **(scene_kwargs or {}))
        self.vad_backend = vad_backend
        self.vad_kwargs = vad_kwargs or {}
        self.language = language
        self.postprocessor = postprocessor
        self.pack = pack
        self.keep_intermediates = keep_intermediates

    # ------------------------------------------------------------------
    def collect_windows(self, audio: np.ndarray,
                        sample_rate: int) -> Tuple[List[Window], Dict]:
        """Scene detection + per-scene VAD -> flat window list."""
        t0 = time.time()
        scene_result = self.scene_detector.detect(audio, sample_rate)
        stage_s = {"scene": time.time() - t0, "vad": 0.0}
        segmenter = create_segmenter(self.vad_backend, **self.vad_kwargs)
        windows: List[Window] = []
        vad_stats = {"scenes": len(scene_result.scenes), "groups": 0,
                     "failovers": 0}
        for scene in scene_result.scenes:
            a = int(scene.start * sample_rate)
            b = int(scene.end * sample_rate)
            scene_audio = audio[a:b]
            t0 = time.time()
            seg = segmenter.segment(scene_audio, sample_rate)
            stage_s["vad"] += time.time() - t0
            if vad_failover_check(seg):
                # implausibly low coverage -> full-clip transcription
                seg = NullSegmenter().segment(scene_audio, sample_rate)
                vad_stats["failovers"] += 1
            windows.extend(windows_from_segmentation(audio, scene, seg,
                                                     sample_rate))
            vad_stats["groups"] += len(seg.groups)
        raw_windows = len(windows)
        if self.pack and len(windows) > 1:
            windows = pack_windows(windows, sample_rate)
        stats = {"scene_backend": scene_result.backend,
                 "scene_stats": scene_result.stats, **vad_stats,
                 "groups_packed": raw_windows,
                 "windows": len(windows),
                 "stage_s": {k: round(v, 3) for k, v in stage_s.items()}}
        return windows, stats

    # ------------------------------------------------------------------
    def process_audio(self, audio: np.ndarray,
                      sample_rate: int = WHISPER_SAMPLE_RATE,
                      seed: int = 0) -> Tuple[List[Subtitle], Dict]:
        """Transcribe in-memory audio -> globally-timed subtitles."""
        t0 = time.time()
        windows, stats = self.collect_windows(audio, sample_rate)
        t_seg = time.time() - t0
        t0 = time.time()
        results = self.engine.transcribe_windows(windows, seed=seed)
        t_asr = time.time() - t0
        subtitles = self.assemble_subtitles(results)
        stats.update({
            "segmentation_s": round(t_seg, 3),
            "asr_s": round(t_asr, 3),
            "audio_s": round(len(audio) / sample_rate, 3),
            "rtf_x": round((len(audio) / sample_rate) / max(t_asr, 1e-9), 2),
            "raw_subtitles": len(subtitles),
        })
        return subtitles, stats

    # ------------------------------------------------------------------
    def assemble_subtitles(self, results) -> List[Subtitle]:
        """Engine results -> globally-timed subtitles: unpack packed
        windows, drop segments that start past a window's audio, clamp
        ends, record per-window diagnostics, stitch."""
        flat_results = []
        for window, segments in results:
            flat_results.extend(unpack_segments(window, segments))
        scene_subs = []
        window_diag = []
        for window, segments in flat_results:
            subs = [Subtitle(0, s.start, min(s.end, window.duration), s.text)
                    for s in segments
                    if s.text.strip() and s.start < window.duration]
            scene_subs.append((subs, window.abs_start))
            window_diag.append({
                "scene": window.scene_idx, "group": window.group_idx,
                "start": round(window.abs_start, 3),
                "duration": round(window.duration, 3),
                "segments": len(segments),
                "avg_logprob": round(segments[0].avg_logprob, 4)
                if segments else None,
                "no_speech_prob": round(segments[0].no_speech_prob, 4)
                if segments else None,
                "chars": sum(len(s.text) for s in segments),
            })
        self._last_window_diagnostics = window_diag
        return stitch(scene_subs)

    # ------------------------------------------------------------------
    def process(self, media: MediaInfo, output_dir: Path,
                seed: int = 0) -> PipelineResult:
        """Full file pipeline; writes ``{basename}.{lang}.whisperjav.srt``,
        ``{basename}.whisperjav.json`` (metadata and stage times) and
        ``{basename}.transcribe.json`` (per-window diagnostics)."""
        wall_t0 = time.time()
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        logger.info("processing %s", media.path.name)

        t_extract = time.time()
        audio, duration = AudioExtractor(WHISPER_SAMPLE_RATE).extract(
            media.path)
        t_extract = time.time() - t_extract

        subtitles, stats = self.process_audio(audio, WHISPER_SAMPLE_RATE,
                                              seed=seed)
        if self.keep_intermediates:
            save_srt(output_dir / (f"{media.basename}.{self.language}"
                                   ".whisperjav.raw.srt"), subtitles)

        sanitize_stats = {}
        t_sanitize = time.time()
        if self.postprocessor is not None:
            subtitles, sanitize_stats = self.postprocessor.process(
                subtitles, language=self.language)
        t_sanitize = time.time() - t_sanitize
        stage = stats.setdefault("stage_s", {})
        stage["extract"] = round(t_extract, 3)
        stage["sanitize"] = round(t_sanitize, 3)
        stage["asr"] = stats.get("asr_s", 0.0)
        wall = time.time() - wall_t0
        stats["e2e_wall_s"] = round(wall, 3)
        stats["e2e_rtf_x"] = round(duration / max(wall, 1e-9), 2)
        artifacts = (sanitize_stats.pop("artifacts", [])
                     if isinstance(sanitize_stats, dict) else [])
        stats["final_subtitles"] = len(subtitles)
        stats["sanitization"] = sanitize_stats

        srt_path = (output_dir
                    / f"{media.basename}.{self.language}.whisperjav.srt")
        save_srt(srt_path, subtitles)
        if artifacts:
            from whisperjav_tpu.modules.sanitize.sanitizer import (
                write_artifacts_srt,
            )
            write_artifacts_srt(output_dir / (f"{media.basename}."
                                              f"{self.language}.whisperjav"
                                              ".artifacts.srt"),
                                artifacts, sanitize_stats)
            stats["artifacts_removed"] = len(artifacts)

        metadata = {"input": str(media.path), "duration_s": duration,
                    "output": str(srt_path), "stats": stats}
        (output_dir / f"{media.basename}.whisperjav.json").write_text(
            json.dumps(metadata, indent=2, default=str), encoding="utf-8")
        (output_dir / f"{media.basename}.transcribe.json").write_text(
            json.dumps({"windows": self._last_window_diagnostics}, indent=1,
                       default=str), encoding="utf-8")
        logger.info("wrote %s (%d subtitles, RTF %sx)", srt_path.name,
                    len(subtitles), stats.get("rtf_x"))
        return PipelineResult(media, srt_path, subtitles, metadata)
