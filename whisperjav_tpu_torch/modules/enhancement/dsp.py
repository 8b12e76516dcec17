"""Host-side DSP enhancement: filter chains without ffmpeg.

The port's copy of ``whisperjav_tpu/modules/enhancement/dsp.py``.

Role parity with the reference's ffmpeg-dsp backend (reference:
whisperjav/modules/speech_enhancement/backends/ffmpeg_dsp.py — loudnorm,
denoise, compress, highpass, lowpass, deess chains), implemented directly
with scipy.signal so it works in ffmpeg-less environments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from scipy import signal

from whisperjav_tpu_torch.modules.enhancement.base import EnhancementResult


@dataclass
class DspConfig:
    highpass_hz: Optional[float] = 80.0
    lowpass_hz: Optional[float] = 7500.0
    # simple RMS loudness normalization target (dBFS)
    loudnorm_target_db: Optional[float] = -20.0
    # soft-knee compressor
    compress_threshold_db: Optional[float] = -18.0
    compress_ratio: float = 3.0
    deess: bool = False
    deess_hz: float = 6000.0
    deess_reduction_db: float = 6.0


class DspEnhancer:
    name = "dsp"
    is_lightweight = True

    def __init__(self, **kwargs):
        self.config = DspConfig(**kwargs)

    def get_preferred_sample_rate(self) -> int:
        return 16_000

    def enhance(self, audio: np.ndarray, sample_rate: int) -> EnhancementResult:
        cfg = self.config
        x = np.asarray(audio, np.float64)
        applied: List[str] = []

        nyq = sample_rate / 2.0
        if cfg.highpass_hz and 0 < cfg.highpass_hz < nyq:
            sos = signal.butter(4, cfg.highpass_hz / nyq, "highpass",
                                output="sos")
            x = signal.sosfiltfilt(sos, x)
            applied.append("highpass")
        if cfg.lowpass_hz and 0 < cfg.lowpass_hz < nyq:
            sos = signal.butter(4, cfg.lowpass_hz / nyq, "lowpass",
                                output="sos")
            x = signal.sosfiltfilt(sos, x)
            applied.append("lowpass")

        if cfg.deess:
            # narrow notch-style shelf around the sibilance band
            lo = max(cfg.deess_hz - 1500, 100) / nyq
            hi = min(cfg.deess_hz + 1500, nyq - 100) / nyq
            sos = signal.butter(2, [lo, hi], "bandpass", output="sos")
            sibilant = signal.sosfiltfilt(sos, x)
            gain = 10 ** (-cfg.deess_reduction_db / 20.0)
            x = x - sibilant * (1.0 - gain)
            applied.append("deess")

        if cfg.compress_threshold_db is not None:
            # envelope follower + downward compression above threshold
            env = np.abs(signal.hilbert(x)) + 1e-9
            env_db = 20 * np.log10(env)
            over = np.maximum(env_db - cfg.compress_threshold_db, 0.0)
            gain_db = -over * (1.0 - 1.0 / cfg.compress_ratio)
            # smooth gain (50 ms attack/release)
            win = max(1, int(0.05 * sample_rate))
            kernel = np.ones(win) / win
            gain_db = np.convolve(gain_db, kernel, mode="same")
            x = x * 10 ** (gain_db / 20.0)
            applied.append("compress")

        if cfg.loudnorm_target_db is not None:
            rms = np.sqrt(np.mean(x ** 2)) + 1e-12
            target = 10 ** (cfg.loudnorm_target_db / 20.0)
            x = x * (target / rms)
            applied.append("loudnorm")

        peak = np.max(np.abs(x)) + 1e-12
        if peak > 0.99:
            x = x * (0.99 / peak)

        return EnhancementResult(x.astype(np.float32), sample_rate, True,
                                 self.name, {"filters": applied})
