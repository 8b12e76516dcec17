"""Audio extraction: any container → mono float32 PCM at a target rate.

Role parity with reference ``whisperjav/modules/audio_extraction.py:33-103``
(ffmpeg subprocess → 16 kHz mono WAV). Here WAV inputs decode natively
(no ffmpeg needed); other containers require ffmpeg on PATH, surfaced as a
clear error otherwise.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from whisperjav_tpu_torch.modules.audio_io import (
    WHISPER_SAMPLE_RATE, read_wav, resample, write_wav,
)
from whisperjav_tpu_torch.utils.logger import logger


class FFmpegNotFoundError(RuntimeError):
    pass


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_audio_ffmpeg(
    path: Union[str, Path],
    sample_rate: int = WHISPER_SAMPLE_RATE,
) -> np.ndarray:
    """Decode any container via ffmpeg to mono float32 at ``sample_rate``.

    Streams raw f32le PCM over a pipe (no temp WAV round-trip).
    """
    if not ffmpeg_available():
        raise FFmpegNotFoundError(
            f"ffmpeg is required to decode non-WAV input {path}; install ffmpeg "
            "or provide 16 kHz mono WAV files."
        )
    cmd = [
        "ffmpeg", "-nostdin", "-v", "error",
        "-i", str(path),
        "-ac", "1", "-ar", str(sample_rate),
        "-f", "f32le", "-acodec", "pcm_f32le", "pipe:1",
    ]
    proc = subprocess.run(cmd, capture_output=True, timeout=3600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"ffmpeg failed on {path}: {proc.stderr.decode(errors='replace')[-2000:]}"
        )
    return np.frombuffer(proc.stdout, dtype=np.float32).copy()


class AudioExtractor:
    """Extract audio from media to mono float32 at the pipeline rate.

    The extraction rate is negotiated with the enhancement backend (e.g.
    48 kHz when a 48 kHz enhancer is configured; reference:
    whisperjav/pipelines/balanced_pipeline.py:172-175).
    """

    def __init__(self, sample_rate: int = WHISPER_SAMPLE_RATE):
        self.sample_rate = sample_rate

    def extract(self, media_path: Union[str, Path]) -> Tuple[np.ndarray, float]:
        """Returns (audio, duration_seconds)."""
        p = Path(media_path)
        if p.suffix.lower() in (".wav", ".wave"):
            audio, rate = read_wav(p, mono=True)
            audio = resample(audio, rate, self.sample_rate)
        else:
            audio = extract_audio_ffmpeg(p, sample_rate=self.sample_rate)
        duration = len(audio) / float(self.sample_rate)
        logger.debug("extracted %s: %.1fs @ %d Hz", p.name, duration, self.sample_rate)
        return audio, duration

    def extract_to_wav(self, media_path: Union[str, Path], out_path: Union[str, Path]) -> Path:
        audio, _ = self.extract(media_path)
        write_wav(out_path, audio, self.sample_rate, subtype="pcm16")
        return Path(out_path)
