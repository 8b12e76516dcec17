"""Multi-file processing with host-side I/O parallelism.

The port's counterpart of ``whisperjav_tpu/utils/async_processor.py``
(reference: whisperjav/utils/async_processor.py:1-5). A producer thread
extracts each file's audio and runs scene detection, enhancement and VAD
(``pipeline.collect_windows``) for file N+1 while the caller's thread
decodes file N on the engine. Both threads launch on the card's default
stream, so what overlaps is one thread's host work with the other's
device work, not two device streams (an engine over several cards
decodes each card's rows in threads and streams of its own). Grad and
inference mode are per thread: the device functions the producer
reaches (the VAD networks, the enhancers) each enter
``torch.inference_mode`` themselves, and the kernel library's first
load is serialised (``ops/cuda/_build.py``).
Cancellation is cooperative: a file whose decode has not begun is
marked cancelled and writes nothing; one whose decode has begun is
decoded and written in full. Where the pipeline has a ``tracer``
(``--trace-params``), each file's ``file_start``, ``segmentation`` and
``file_complete`` events are written from the caller's thread (the JAX
manager writes none; its ``file_complete`` carries the segmentation
stats, ``audio_s`` and ``final_subtitles``, not the sync path's walls).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from whisperjav_tpu_torch.modules.media_discovery import MediaInfo
from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class FileOutcome:
    media: MediaInfo
    ok: bool
    result: object = None
    error: Optional[str] = None


class AsyncPipelineManager:
    """Overlap host preprocessing with device decoding across files."""

    def __init__(self, pipeline, max_prefetch: int = 2):
        self.pipeline = pipeline
        self.max_prefetch = max_prefetch
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    # ------------------------------------------------------------------
    def process_files(self, media: Sequence[MediaInfo],
                      output_dir: Path,
                      on_complete: Optional[Callable] = None) -> List[FileOutcome]:
        from whisperjav_tpu_torch.modules.audio_io import WHISPER_SAMPLE_RATE
        from whisperjav_tpu_torch.modules.audio_extraction import AudioExtractor

        prep_q: "queue.Queue" = queue.Queue(maxsize=self.max_prefetch)
        extractor = AudioExtractor(WHISPER_SAMPLE_RATE)

        def producer():
            for m in media:
                if self._cancel.is_set():
                    break
                try:
                    audio, duration = extractor.extract(m.path)
                    windows, stats = self.pipeline.collect_windows(
                        audio, WHISPER_SAMPLE_RATE)
                    prep_q.put((m, windows, stats, duration, None))
                except Exception as e:  # noqa: BLE001 — keep batch going
                    prep_q.put((m, None, None, None, str(e)))
            prep_q.put(None)   # sentinel

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        outcomes: List[FileOutcome] = []
        while True:
            item = prep_q.get()
            if item is None:
                break
            m, windows, stats, duration, err = item
            if self._cancel.is_set():
                outcomes.append(FileOutcome(m, False, error="cancelled"))
                continue
            if err is not None:
                logger.error("preprocessing failed on %s: %s",
                             m.path.name, err)
                outcomes.append(FileOutcome(m, False, error=err))
                continue
            self._trace("file_start", {"file": str(m.path),
                                       "duration": duration})
            self._trace("segmentation", stats)
            try:
                stats = {**stats, "audio_s": round(duration, 3)}
                result = self._decode_and_write(m, windows, stats, output_dir)
                outcomes.append(FileOutcome(m, True, result=result))
                if on_complete:
                    on_complete(m, result)
            except Exception as e:  # noqa: BLE001
                logger.error("decode failed on %s: %s", m.path.name, e)
                outcomes.append(FileOutcome(m, False, error=str(e)))
        t.join(timeout=5.0)
        return outcomes

    def _trace(self, kind: str, data) -> None:
        tracer = getattr(self.pipeline, "tracer", None)
        if tracer:
            tracer.event(kind, data)

    # ------------------------------------------------------------------
    def _decode_and_write(self, media: MediaInfo, windows, stats,
                          output_dir: Path) -> Path:
        """Decode, assemble, sanitize and write the SRT; its path."""
        from whisperjav_tpu_torch.modules.srt import save_srt

        results = self.pipeline.engine.transcribe_windows(windows)
        # shared assembly path: packing/chunking reconciliation and window
        # diagnostics stay identical to the sync pipeline
        subtitles = self.pipeline.assemble_subtitles(results)
        if self.pipeline.postprocessor is not None:
            subtitles, _ = self.pipeline.postprocessor.process(
                subtitles, language=self.pipeline.language)
        from whisperjav_tpu_torch.modules.media_discovery import resolve_output_dir
        output_dir = resolve_output_dir(output_dir, media)
        output_dir.mkdir(parents=True, exist_ok=True)
        srt_path = output_dir / (
            f"{media.basename}.{self.pipeline.language}.whisperjav.srt")
        save_srt(srt_path, subtitles)
        self._trace("file_complete", {**stats,
                                      "final_subtitles": len(subtitles)})
        return srt_path
