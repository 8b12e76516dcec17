"""Two-pass ensemble orchestrator: one process, two pipelines on one card.

The port's counterpart of ``whisperjav_tpu/ensemble/orchestrator.py``:
both passes run in this process, one after the other, each a pipeline
built by ``pipelines/factory.py`` on ``device``; pass-2 failure degrades
to pass-1 output with a 'degraded' status, pass-1 failure is 'failed'.
Batch-major order builds pass 1, runs every file, drops the pipeline
(its memory back to the allocator before pass 2 is built, so two large
models never share the card), then builds pass 2; ``serial_mode``
(``--ensemble-serial``) builds both pipelines per file, as the JAX
package does. A qwen-mode pass goes through ``build_pipeline`` as in the
JAX package, which has no qwen model: batch-major raises, serial marks
each file failed.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from whisperjav_tpu_torch.config.presets import PipelineConfig
from whisperjav_tpu_torch.ensemble.merge import MergeEngine
from whisperjav_tpu_torch.modules.media_discovery import MediaInfo
from whisperjav_tpu_torch.modules.srt import Subtitle, save_srt
from whisperjav_tpu_torch.pipelines.engine import release_device_memory
from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class EnsembleFileResult:
    media: MediaInfo
    status: str                  # ok | degraded | failed
    srt_path: Optional[Path] = None
    merge_stats: Optional[Dict] = None
    error: Optional[str] = None


def apply_ensemble_safety_caps(pass1: PipelineConfig,
                               pass2: PipelineConfig) -> List[str]:
    """Config-combination guards (reference: ensemble/safety_caps.py:1-60
    capped fidelity+aggressive pass-2 because of a non-deterministic
    CTranslate2 failure, which this runtime does not have), as in the JAX
    package: no combination is rewritten; the hook reports, and stays the
    one place an empirical cap would land."""
    notes = []
    if (pass1.mode.name == pass2.mode.name
            and pass1.sensitivity.name == pass2.sensitivity.name):
        notes.append("pass1 and pass2 configs are identical; the merge "
                     "will be a no-op")
    return notes


class EnsembleOrchestrator:
    def __init__(
        self,
        pass1_cfg: PipelineConfig,
        pass2_cfg: PipelineConfig,
        merge_strategy: str = "smart_merge",
        checkpoint: Optional[str] = None,
        postprocessor=None,
        serial_mode: bool = False,
        device="cuda",
    ):
        for note in apply_ensemble_safety_caps(pass1_cfg, pass2_cfg):
            logger.warning("ensemble: %s", note)
        self.pass1_cfg = pass1_cfg
        self.pass2_cfg = pass2_cfg
        self.merge = MergeEngine(merge_strategy)
        self.checkpoint = checkpoint
        self.postprocessor = postprocessor
        self.serial_mode = serial_mode
        self.device = device

    def _build(self, cfg: PipelineConfig):
        from whisperjav_tpu_torch.pipelines.factory import build_pipeline
        return build_pipeline(cfg, checkpoint=self.checkpoint,
                              postprocessor=None, device=self.device)

    def _release(self) -> None:
        """Return a dropped pipeline's memory before the next is built."""
        release_device_memory(self.device)

    # ------------------------------------------------------------------
    def process_batch(self, media: Sequence[MediaInfo],
                      output_dir: Path) -> Dict:
        """Run pass1 over all files, then pass2, then merge per file;
        writes ``ensemble_batch.json`` and returns its summary.

        Batch-major order holds one model on the card at a time.
        ``serial_mode`` processes file-at-a-time instead (reference:
        ensemble/orchestrator.py:110-115).
        """
        t0 = time.time()

        if self.serial_mode:
            results = [self._process_one(m, output_dir) for m in media]
        else:
            results = self._process_batch_major(media, output_dir)

        # batch summary lands in the shared dir, or (source mode) next
        # to the first input file
        from whisperjav_tpu_torch.modules.media_discovery import (
            is_source_sentinel, resolve_output_dir,
        )
        if media and is_source_sentinel(output_dir):
            summary_dir = resolve_output_dir(output_dir, media[0])
        else:
            summary_dir = Path(output_dir)
        summary_dir.mkdir(parents=True, exist_ok=True)

        summary = {
            "files": len(media),
            "ok": sum(1 for r in results if r.status == "ok"),
            "degraded": sum(1 for r in results if r.status == "degraded"),
            "failed": sum(1 for r in results if r.status == "failed"),
            "wall_s": round(time.time() - t0, 2),
            "results": [
                {"file": str(r.media.path), "status": r.status,
                 "output": str(r.srt_path) if r.srt_path else None,
                 "merge": r.merge_stats, "error": r.error}
                for r in results
            ],
        }
        (summary_dir / "ensemble_batch.json").write_text(
            json.dumps(summary, indent=2, default=str), encoding="utf-8")
        return summary

    # ------------------------------------------------------------------
    def _run_pass(self, pipeline, media: MediaInfo) -> List[Subtitle]:
        from whisperjav_tpu_torch.modules.audio_io import WHISPER_SAMPLE_RATE
        from whisperjav_tpu_torch.modules.audio_extraction import AudioExtractor
        audio, _ = AudioExtractor(WHISPER_SAMPLE_RATE).extract(media.path)
        subs, _ = pipeline.process_audio(audio, WHISPER_SAMPLE_RATE)
        return subs

    def _finalize(self, media: MediaInfo, output_dir: Path,
                  subs: List[Subtitle], status: str,
                  merge_stats: Optional[Dict],
                  language: str) -> EnsembleFileResult:
        if self.postprocessor is not None:
            subs, _ = self.postprocessor.process(subs, language=language)
        from whisperjav_tpu_torch.modules.media_discovery import resolve_output_dir
        out = resolve_output_dir(output_dir, media)
        out.mkdir(parents=True, exist_ok=True)
        srt_path = out / f"{media.basename}.{language}.whisperjav.srt"
        save_srt(srt_path, subs)
        return EnsembleFileResult(media, status, srt_path, merge_stats)

    def _process_batch_major(self, media, output_dir):
        lang = self.pass1_cfg.language
        pass1_out: Dict[str, List[Subtitle]] = {}
        pass2_out: Dict[str, Optional[List[Subtitle]]] = {}
        errors: Dict[str, str] = {}

        p1 = self._build(self.pass1_cfg)
        for m in media:
            try:
                pass1_out[str(m.path)] = self._run_pass(p1, m)
            except Exception as e:  # noqa: BLE001
                errors[str(m.path)] = f"pass1: {e}"
                logger.error("ensemble pass1 failed on %s: %s",
                             m.path.name, e)
        del p1
        self._release()

        p2 = None
        try:
            p2 = self._build(self.pass2_cfg)
        except Exception as e:  # noqa: BLE001
            logger.error("ensemble pass2 build failed: %s", e)
        if p2 is not None:
            for m in media:
                if str(m.path) not in pass1_out:
                    continue
                try:
                    pass2_out[str(m.path)] = self._run_pass(p2, m)
                except Exception as e:  # noqa: BLE001
                    pass2_out[str(m.path)] = None
                    logger.error("ensemble pass2 failed on %s: %s",
                                 m.path.name, e)
            del p2
            self._release()

        results = []
        for m in media:
            key = str(m.path)
            if key not in pass1_out:
                results.append(EnsembleFileResult(m, "failed",
                                                  error=errors.get(key)))
                continue
            p2_subs = pass2_out.get(key)
            if p2_subs is None:
                results.append(self._finalize(m, output_dir, pass1_out[key],
                                              "degraded", None, lang))
                continue
            merged, stats = self.merge.merge(pass1_out[key], p2_subs)
            results.append(self._finalize(m, output_dir, merged, "ok",
                                          stats.to_dict(), lang))
        return results

    def _process_one(self, m: MediaInfo, output_dir: Path) -> EnsembleFileResult:
        lang = self.pass1_cfg.language
        try:
            p1_subs = self._run_pass(self._build(self.pass1_cfg), m)
        except Exception as e:  # noqa: BLE001
            return EnsembleFileResult(m, "failed", error=f"pass1: {e}")
        try:
            p2_subs = self._run_pass(self._build(self.pass2_cfg), m)
        except Exception as e:  # noqa: BLE001
            logger.error("ensemble pass2 failed on %s: %s", m.path.name, e)
            return self._finalize(m, output_dir, p1_subs, "degraded",
                                  None, lang)
        merged, stats = self.merge.merge(p1_subs, p2_subs)
        return self._finalize(m, output_dir, merged, "ok", stats.to_dict(),
                              lang)
