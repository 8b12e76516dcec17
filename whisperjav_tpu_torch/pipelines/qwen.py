"""Qwen/ChronosJAV pipeline: semantic scenes → decoupled assembly → SRT.

Flow parity with the reference QwenPipeline (reference: whisperjav/
pipelines/qwen_pipeline.py:87-1056 — phases: extract, semantic scene
detection with safe chunking clamping scenes to 12–48 s for the
aligner's 180 s limit, optional enhancement, per-scene VAD,
DecoupledSubtitlePipeline, per-scene SRT, stitch, light sanitize
(anime-style ellipsis filtering only), analytics).

The port's copy of ``whisperjav_tpu/pipelines/qwen.py``: the decoupled
stack's generator and aligner run on the device they were built for,
and an enhancer on ``device``. The metadata JSON has the JAX package's
shape (``stats.stage_s``, ``e2e_rtf_x``, ``scene_diagnostics``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from whisperjav_tpu_torch.modules.analytics import (
    compute_full_analytics, print_summary,
)
from whisperjav_tpu_torch.modules.audio_io import WHISPER_SAMPLE_RATE
from whisperjav_tpu_torch.modules.audio_extraction import AudioExtractor
from whisperjav_tpu_torch.modules.media_discovery import MediaInfo
from whisperjav_tpu_torch.modules.scene_detection import create_scene_detector
from whisperjav_tpu_torch.modules.srt import save_srt, stitch
from whisperjav_tpu_torch.modules.subtitle_pipeline.orchestrator import (
    DecoupledSubtitlePipeline,
)
from whisperjav_tpu_torch.pipelines.transcribe import PipelineResult
from whisperjav_tpu_torch.utils.logger import logger

# safe chunking bounds against the aligner's limit
# (reference: qwen_pipeline.py:98-100, 211-214)
SCENE_MIN_S = 12.0
SCENE_MAX_S = 48.0


def safe_chunk_scenes(scenes, max_s: float = SCENE_MAX_S,
                      min_s: float = SCENE_MIN_S):
    """Clamp scene list to [min_s, max_s] durations: split long scenes
    evenly, merge a too-short scene into its predecessor."""
    from whisperjav_tpu_torch.modules.scene_detection.base import Scene
    out: List[Scene] = []
    for sc in scenes:
        if sc.duration > max_s:
            n = int(np.ceil(sc.duration / max_s))
            step = sc.duration / n
            for i in range(n):
                out.append(Scene(len(out), sc.start + i * step,
                                 sc.start + (i + 1) * step, sc.scene_type))
        elif out and sc.duration < min_s and \
                out[-1].duration + sc.duration <= max_s:
            out[-1] = Scene(out[-1].index, out[-1].start, sc.end,
                            out[-1].scene_type)
        else:
            out.append(Scene(len(out), sc.start, sc.end, sc.scene_type))
    for i, sc in enumerate(out):
        sc.index = i
    return out


class QwenPipeline:
    def __init__(
        self,
        decoupled: DecoupledSubtitlePipeline,
        scene_backend: str = "semantic",
        scene_kwargs: Optional[Dict] = None,
        enhancer_backend: Optional[str] = None,
        language: str = "ja",
        safe_chunking: bool = True,
        scene_min_s: float = SCENE_MIN_S,
        scene_max_s: float = SCENE_MAX_S,
        device="cuda",
    ):
        # --qwen-safe-chunking / --qwen-scene-min/max-duration (reference:
        # main.py:536-545 — enforce scene bounds for the aligner's 180 s
        # limit; disabling allows arbitrarily long scenes)
        self.safe_chunking = safe_chunking
        self.scene_min_s = scene_min_s
        self.scene_max_s = scene_max_s
        self.decoupled = decoupled
        self.scene_detector = create_scene_detector(
            scene_backend, device=device, **(scene_kwargs or {}))
        from whisperjav_tpu_torch.modules.enhancement import (
            create_enhancer, is_passthrough_backend,
        )
        # no enhancer kwargs, as in the JAX package: --qwen-enhancer-model
        # never reaches the backend, so a network enhancer passes audio
        # through (a fault of the reference, kept; ROADMAP section 3)
        self.enhancer = (None if is_passthrough_backend(enhancer_backend)
                         else create_enhancer(enhancer_backend,
                                              device=device))
        self.language = language

    # ------------------------------------------------------------------
    def process_audio(self, audio: np.ndarray, sample_rate: int,
                      title: str = "audio"):
        """Full qwen stack over an in-memory waveform; returns
        (subtitles, stats). A resident engine calls this directly;
        ``process`` wraps it with file IO + metadata."""
        if sample_rate != WHISPER_SAMPLE_RATE:
            from whisperjav_tpu_torch.modules.audio_io import resample
            audio = resample(audio, sample_rate, WHISPER_SAMPLE_RATE)
        t0 = time.time()
        duration = len(audio) / WHISPER_SAMPLE_RATE

        stage_s: Dict[str, float] = {}
        t_ph = time.time()
        scene_result = self.scene_detector.detect(audio, WHISPER_SAMPLE_RATE)
        scenes = (safe_chunk_scenes(scene_result.scenes,
                                    max_s=self.scene_max_s,
                                    min_s=self.scene_min_s)
                  if self.safe_chunking else list(scene_result.scenes))
        stage_s["scenes"] = round(time.time() - t_ph, 3)

        # phase 3: enhancement (graceful)
        t_ph = time.time()
        scene_audios = []
        enhanced, engines = 0, set()
        for sc in scenes:
            a = int(sc.start * WHISPER_SAMPLE_RATE)
            b = int(sc.end * WHISPER_SAMPLE_RATE)
            clip = audio[a:b]
            if self.enhancer is not None:
                from whisperjav_tpu_torch.modules.enhancement import enhance_scenes
                res = enhance_scenes(self.enhancer, [clip],
                                     WHISPER_SAMPLE_RATE)[0]
                if res.success:
                    clip = res.audio
                    enhanced += 1
                    engines.add(res.stats.get("engine", res.backend))
            scene_audios.append(clip)
        stage_s["enhance"] = round(time.time() - t_ph, 3)

        # phases 4-5: decoupled assembly per scene
        outputs = self.decoupled.process_scenes(scene_audios,
                                                WHISPER_SAMPLE_RATE)
        # aggregate the orchestrator's per-scene step walls
        # (frame/generate/clean/align/assemble) for file-level RTF
        # attribution (reference whole-path: qwen_pipeline.py:530-1056)
        for out in outputs:
            for k, v in out.diagnostics.stage_s.items():
                stage_s[k] = round(stage_s.get(k, 0.0) + v, 3)

        # phases 6-7: per-scene cues → global stitch
        scene_subs = [(out.subtitles, scenes[i].start)
                      for i, out in enumerate(outputs)]
        subtitles = stitch(scene_subs)

        # phase 8: light sanitization only (reference bypasses the full
        # sanitizer for qwen output, qwen_pipeline.py:960-1005)
        subtitles = [s for s in subtitles if s.text.strip("…・.")]

        # phase 9: analytics — full report with scene/alignment/timing
        # metric families + scorecard (reference: pipeline_analytics
        # called at qwen_pipeline.py:1056)
        diagnostics = [o.diagnostics.to_dict() for o in outputs]
        analytics = compute_full_analytics(
            subtitles, duration,
            scene_spans=[(sc.start, sc.end) for sc in scenes],
            scene_diagnostics=diagnostics)
        print_summary(analytics, title=title)

        wall = round(time.time() - t0, 2)
        stats = {
            "e2e_wall_s": wall,
            "e2e_rtf_x": round(duration / max(wall, 1e-9), 2),
            "stage_s": stage_s,
            "final_subtitles": len(subtitles),
            "windows": sum(d.get("frames", 0) for d in diagnostics),
            "audio_s": round(duration, 3),
            "scenes": len(scenes),
            **({"enhanced_scenes": enhanced,
                "enhancer": {"backend": self.enhancer.name,
                             "engines": sorted(engines)}}
               if self.enhancer is not None else {}),
            "analytics": analytics,
            "scene_diagnostics": diagnostics,
        }
        return subtitles, stats

    # ------------------------------------------------------------------
    def process(self, media: MediaInfo, output_dir: Path) -> PipelineResult:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        logger.info("qwen pipeline: %s", media.path.name)

        t_ph = time.time()
        audio, duration = AudioExtractor(WHISPER_SAMPLE_RATE).extract(
            media.path)
        extract_s = round(time.time() - t_ph, 3)

        subtitles, stats = self.process_audio(
            audio, WHISPER_SAMPLE_RATE, title=media.path.name)
        stats = dict(stats)
        analytics = stats.pop("analytics")
        diagnostics = stats.pop("scene_diagnostics")
        n_scenes = stats.pop("scenes")
        stage_s = dict(stats["stage_s"])
        stage_s["extract"] = extract_s

        srt_path = output_dir / f"{media.basename}.{self.language}.whisperjav.srt"
        save_srt(srt_path, subtitles)
        wall = round(time.time() - t0, 2)
        stats.update({
            "e2e_wall_s": wall,
            "e2e_rtf_x": round(duration / max(wall, 1e-9), 2),
            "stage_s": stage_s,
        })
        metadata = {
            "input": str(media.path),
            "pipeline": "qwen",
            "duration_s": duration,
            "scenes": n_scenes,
            "analytics": analytics,
            "scene_diagnostics": diagnostics,
            "wall_s": wall,
            # same stats shape the transcribe pipeline emits, so
            # file-level harnesses (tools/e2e_bench) grade qwen mode too
            "stats": stats,
        }
        (output_dir / f"{media.basename}.whisperjav.json").write_text(
            json.dumps(metadata, indent=2, ensure_ascii=False, default=str),
            encoding="utf-8")
        logger.info("qwen pipeline wrote %s (%d cues, health=%s)",
                    srt_path.name, len(subtitles), analytics["health"])
        return PipelineResult(media, srt_path, subtitles, metadata)
