"""DecoupledSubtitlePipeline: frame → generate → clean → align →
sentinel → reconstruct → harden, with step-down retry.

The port's copy of ``whisperjav_tpu/modules/subtitle_pipeline/
orchestrator.py`` (reference: whisperjav/modules/subtitle_pipeline/
orchestrator.py:61-717 per ADR-006, step-down retry at :162-221). Clips
stay in memory as arrays, and the generator and aligner stay resident
(load()/unload() are hooks). Cross-scene pooling is the default;
``pool_scenes=False`` runs scene by scene.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.modules.srt import Subtitle
from whisperjav_tpu_torch.modules.subtitle_pipeline.hardening import harden_words
from whisperjav_tpu_torch.modules.subtitle_pipeline.reconstruction import (
    RegroupConfig, regroup_words,
)
from whisperjav_tpu_torch.modules.subtitle_pipeline.sentinel import (
    assess_alignment_quality, redistribute_collapsed_words,
)
from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    FramingResult, HardeningConfig, RegroupMode, SceneDiagnostics,
    StepDownConfig, WordTimestamp,
)
from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class SceneOutput:
    scene_index: int
    subtitles: List[Subtitle]
    diagnostics: SceneDiagnostics


class DecoupledSubtitlePipeline:
    def __init__(
        self,
        framer,
        generator,
        cleaner,
        aligner,
        max_group_s: float = 6.0,
        step_down: Optional[StepDownConfig] = None,
        hardening: Optional[HardeningConfig] = None,
        regroup_mode: RegroupMode = RegroupMode.STANDARD,
        regroup_config: Optional[RegroupConfig] = None,
        pool_scenes: Optional[bool] = None,
    ):
        self.framer = framer
        self.generator = generator
        self.cleaner = cleaner
        self.aligner = aligner
        self.max_group_s = max_group_s
        # fresh default instances per pipeline (no shared mutable defaults)
        self.step_down = step_down or StepDownConfig()
        self.hardening = hardening or HardeningConfig()
        self.regroup_mode = regroup_mode
        self.regroup_config = regroup_config or RegroupConfig()
        self.pool_scenes = pool_scenes

    # ------------------------------------------------------------------
    def process_scenes(
        self,
        scene_audios: Sequence[np.ndarray],
        sample_rate: int,
    ) -> List[SceneOutput]:
        """Run the full decoupled flow over all scenes.

        Default is cross-scene pooling: every scene is framed first, then
        all frames generate/clean/align in full device batches, then the
        results scatter back per scene (step-down retries pool the same
        way in a second pass). ``pool_scenes=False`` (and a single scene)
        runs the reference's scene-by-scene loop; ``pool_scenes=None``
        leaves it to ``WJAV_POOL_SCENES``, read on each call as the JAX
        package does ("0": scene by scene).
        """
        self.generator.load()
        self.aligner.load()
        try:
            pooled = self.pool_scenes
            if pooled is None:
                pooled = os.environ.get("WJAV_POOL_SCENES", "1") != "0"
            if pooled and len(scene_audios) > 1:
                return self._process_scenes_pooled(scene_audios,
                                                   sample_rate)
            return [self._process_scene(si, audio, sample_rate)
                    for si, audio in enumerate(scene_audios)]
        finally:
            self.generator.unload()
            self.aligner.unload()

    # ------------------------------------------------------------------
    def _process_scenes_pooled(
        self,
        scene_audios: Sequence[np.ndarray],
        sample_rate: int,
    ) -> List[SceneOutput]:
        t0 = time.time()
        jobs = list(enumerate(scene_audios))
        results = self._pooled_pass(jobs, sample_rate, self.max_group_s)

        if self.step_down.enabled:
            # same per-scene semantics as _process_scene's retry loop
            # (adopt-iff-improved, stop a scene on no-improvement or
            # clean), pooled: ONE batched pass covers every retrying
            # scene per round
            eligible = {si for si, _ in jobs}
            for _ in range(self.step_down.max_retries):
                retry_jobs = [
                    (si, scene_audios[si]) for si in sorted(eligible)
                    if results[si][2].collapsed_frames > 0
                    or not results[si][0]]
                if not retry_jobs:
                    break
                for si, _ in retry_jobs:
                    logger.info(
                        "scene %d: step-down retry at %.1fs groups "
                        "(%d collapsed frames)", si,
                        self.step_down.fallback_max_group_s,
                        results[si][2].collapsed_frames)
                retries = self._pooled_pass(
                    retry_jobs, sample_rate,
                    self.step_down.fallback_max_group_s)
                for si, (r_words, r_framing, r_diag) in retries.items():
                    words, _framing, diag = results[si]
                    r_diag.step_down_retries = diag.step_down_retries + 1
                    r_diag.hardening_actions = diag.hardening_actions
                    better = (r_words and (not words
                              or r_diag.collapsed_frames
                              < diag.collapsed_frames))
                    if better:
                        results[si] = (r_words, r_framing, r_diag)
                        if r_diag.collapsed_frames == 0:
                            eligible.discard(si)
                    else:
                        diag.step_down_retries += 1
                        eligible.discard(si)

        outputs = []
        for si in range(len(scene_audios)):
            words, framing, diag = results[si]
            scene_duration = len(scene_audios[si]) / sample_rate
            hardened, actions = harden_words(
                words, scene_duration, self.hardening,
                framing.speech_regions if framing is not None else None)
            diag.hardening_actions += actions
            subs = regroup_words(hardened, self.regroup_mode,
                                 self.regroup_config)
            diag.elapsed_s = round(time.time() - t0, 3)
            outputs.append(SceneOutput(si, subs, diag))
        return outputs

    # ------------------------------------------------------------------
    def _pooled_pass(
        self,
        jobs: Sequence[Tuple[int, np.ndarray]],
        sample_rate: int,
        max_group_s: float,
    ) -> Dict[int, Tuple[List[WordTimestamp], Optional[FramingResult],
                         SceneDiagnostics]]:
        """One frame→generate→clean→align pass over many scenes with
        device work batched ACROSS scenes. Returns per-scene
        (words, framing, diag); pooled stage walls are prorated onto
        scene diags by frame count so file-level attribution still adds
        up."""
        diags = {si: SceneDiagnostics(scene_index=si) for si, _ in jobs}

        t = time.time()
        framings: Dict[int, FramingResult] = {}
        for si, audio in jobs:
            framings[si] = self.framer.frame(audio, sample_rate,
                                             max_group_s)
            diags[si].frames = len(framings[si].frames)
        t_frame = time.time() - t

        keys: List[int] = []
        clips: List[np.ndarray] = []
        for si, audio in jobs:
            for f in framings[si].frames:
                a = int(f.start * sample_rate)
                b = int(f.end * sample_rate)
                clips.append(np.ascontiguousarray(audio[a:b], np.float32))
                keys.append(si)

        results: Dict[int, Tuple[List[WordTimestamp],
                                 Optional[FramingResult],
                                 SceneDiagnostics]] = {}
        if not clips:
            for si, _ in jobs:
                self._prorate(diags[si], {"frame": t_frame}, 1, 1)
                results[si] = ([], framings[si], diags[si])
            return results

        t = time.time()
        gen = self.generator.generate_batch(clips, sample_rate)
        t_generate = time.time() - t
        t = time.time()
        cleaned = self.cleaner.clean_batch(gen)
        t_clean = time.time() - t
        texts = [r.text for r in cleaned]
        t = time.time()
        aligned = self.aligner.align_batch(clips, sample_rate, texts)
        t_align = time.time() - t

        t = time.time()
        total = len(clips)
        pos = 0
        for si, _audio in jobs:
            framing = framings[si]
            n = len(framing.frames)
            diag = diags[si]
            diag.generated_chars = sum(
                len(cleaned[pos + k].text) for k in range(n))
            words = self._merge_frame_words(
                framing, aligned[pos:pos + n], diag)
            pos += n
            results[si] = (words, framing, diag)
        t_assemble = time.time() - t

        walls = {"frame": t_frame, "generate": t_generate,
                 "clean": t_clean, "align": t_align,
                 "assemble": t_assemble}
        for si, _ in jobs:
            self._prorate(diags[si], walls,
                          max(1, diags[si].frames), total)
        return results

    @staticmethod
    def _prorate(diag: SceneDiagnostics, walls: Dict[str, float],
                 frames: int, total_frames: int) -> None:
        share = frames / max(1, total_frames)
        for k, v in walls.items():
            diag.stage_s[k] = round(diag.stage_s.get(k, 0.0) + v * share, 3)

    # ------------------------------------------------------------------
    def _process_scene(self, scene_index: int, audio: np.ndarray,
                       sample_rate: int) -> SceneOutput:
        t0 = time.time()
        diag = SceneDiagnostics(scene_index=scene_index)

        words, framing = self._run_once(audio, sample_rate,
                                        self.max_group_s, diag)

        # step-down retry: any collapsed frame (or an empty scene) re-runs
        # at tighter framing; the retry result wins when it collapses less
        # (reference behavior: re-frame at fallback_max_group_s and retry)
        if (self.step_down.enabled
                and (diag.collapsed_frames > 0 or not words)):
            for _ in range(self.step_down.max_retries):
                diag.step_down_retries += 1
                logger.info("scene %d: step-down retry at %.1fs groups "
                            "(%d collapsed frames)", scene_index,
                            self.step_down.fallback_max_group_s,
                            diag.collapsed_frames)
                retry_diag = SceneDiagnostics(scene_index=scene_index)
                retry_words, retry_framing = self._run_once(
                    audio, sample_rate,
                    self.step_down.fallback_max_group_s, retry_diag)
                better = (retry_words and (not words
                          or retry_diag.collapsed_frames
                          < diag.collapsed_frames))
                if better:
                    words, framing = retry_words, retry_framing
                    retry_diag.step_down_retries = diag.step_down_retries
                    retry_diag.hardening_actions = diag.hardening_actions
                    diag = retry_diag
                    if diag.collapsed_frames == 0:
                        break
                else:
                    break

        scene_duration = len(audio) / sample_rate
        hardened, actions = harden_words(words, scene_duration,
                                         self.hardening,
                                         framing.speech_regions)
        diag.hardening_actions += actions
        subs = regroup_words(hardened, self.regroup_mode,
                             self.regroup_config)
        diag.elapsed_s = round(time.time() - t0, 3)
        return SceneOutput(scene_index, subs, diag)

    # ------------------------------------------------------------------
    def _run_once(self, audio: np.ndarray, sample_rate: int,
                  max_group_s: float, diag: SceneDiagnostics,
                  ) -> Tuple[List[WordTimestamp], FramingResult]:
        def _lap(key, since):
            now = time.time()
            diag.stage_s[key] = round(
                diag.stage_s.get(key, 0.0) + (now - since), 3)
            return now

        # step 1: frame
        t = time.time()
        framing = self.framer.frame(audio, sample_rate, max_group_s)
        t = _lap("frame", t)
        diag.frames = len(framing.frames)
        if not framing.frames:
            return [], framing

        # step 2: slice frames (in-memory)
        clips = []
        for f in framing.frames:
            a = int(f.start * sample_rate)
            b = int(f.end * sample_rate)
            clips.append(np.ascontiguousarray(audio[a:b], np.float32))

        # steps 3-4: generate + clean
        gen = self.generator.generate_batch(clips, sample_rate)
        t = _lap("generate", t)
        cleaned = self.cleaner.clean_batch(gen)
        t = _lap("clean", t)
        diag.generated_chars = sum(len(r.text) for r in cleaned)

        # steps 5-7: align
        texts = [r.text for r in cleaned]
        aligned = self.aligner.align_batch(clips, sample_rate, texts)
        t = _lap("align", t)

        # step 8: sentinel + merge frame words to scene-relative time
        all_words = self._merge_frame_words(framing, aligned, diag)
        _lap("assemble", t)
        return all_words, framing

    # ------------------------------------------------------------------
    @staticmethod
    def _merge_frame_words(framing: FramingResult, aligned,
                           diag: SceneDiagnostics) -> List[WordTimestamp]:
        """Sentinel + merge frame words to scene-relative time (step 8),
        shared by the per-scene and cross-scene-pooled paths."""
        all_words: List[WordTimestamp] = []
        for frame, ar in zip(framing.frames, aligned):
            diag.aligned_words += len(ar.words)
            diag.null_timestamp_words += sum(
                1 for w in ar.words if w.start is None or w.end is None)
            quality = assess_alignment_quality(ar.words, frame.duration)
            words = ar.words
            if quality.collapsed:
                diag.collapsed_frames += 1
                words = redistribute_collapsed_words(
                    words, frame.duration, frame.speech_regions)
            for w in words:
                all_words.append(WordTimestamp(
                    w.word,
                    None if w.start is None else w.start + frame.start,
                    None if w.end is None else w.end + frame.start,
                    w.prob))
        return all_words
