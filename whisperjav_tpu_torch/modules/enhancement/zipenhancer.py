"""ZipEnhancer-class backend: chunked denoising with crossfade, on a torch
device.

Counterpart of ``whisperjav_tpu/modules/enhancement/zip_jax.py``: 10 s
chunks with a 0.5 s crossfade at 16 kHz, one chunk at a time, through
the dual-path network (``models/enhancement/zipenhancer.py``) or the
legacy U-Net (``models/enhancement/zipnet.py``), whichever tree the
weights file holds. The model lives on ``device``. Without weights the
backend passes audio through with success=False (the framework's
graceful-degradation contract).

Chunking contract parity with the reference backend (reference:
whisperjav/modules/speech_enhancement/backends/zipenhancer.py:36-51).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from whisperjav_tpu_torch.modules.enhancement.base import (
    EnhancementResult, chunked_crossfade,
)
from whisperjav_tpu_torch.utils.logger import logger

CHUNK_S = 10.0
CROSSFADE_S = 0.5
SR = 16_000


@dataclass
class ZipEnhancerConfig:
    weights: Optional[str] = None
    chunk_s: float = CHUNK_S
    crossfade_s: float = CROSSFADE_S


class ZipEnhancer:
    name = "zipenhancer"
    is_lightweight = True   # ~2 M params

    def __init__(self, device="cuda", **kwargs):
        self.config = ZipEnhancerConfig(**kwargs)
        self.device = torch.device(device)
        self._model = None
        self._model_cfg = None
        self._legacy = False
        if self.config.weights:
            files = np.load(self.config.weights).files
            if any(k.startswith("enc_conv1") or k == "__cfg__"
                   for k in files):
                from whisperjav_tpu_torch.models.enhancement import (
                    zipenhancer,
                )
                self._model, self._model_cfg = zipenhancer.load_params(
                    self.config.weights, self.device)
            else:
                from whisperjav_tpu_torch.models.enhancement import zipnet
                self._model = zipnet.load_params(self.config.weights,
                                                 self.device)
                self._legacy = True
            logger.info("zipenhancer: loaded %s weights from %s on %s",
                        "unet" if self._legacy else "dual-path",
                        self.config.weights, self.device)

    def get_preferred_sample_rate(self) -> int:
        return SR

    def enhance(self, audio: np.ndarray, sample_rate: int) -> EnhancementResult:
        if self._model is None:
            return EnhancementResult(audio, sample_rate, False, self.name,
                                     {"reason": "no weights loaded"})
        if sample_rate != SR:
            from whisperjav_tpu_torch.modules.audio_io import resample
            audio = resample(audio, sample_rate, SR)
            sample_rate = SR
        chunk = int(self.config.chunk_s * SR)
        fade = int(self.config.crossfade_s * SR)
        if len(audio) == 0:
            return EnhancementResult(audio, sample_rate, True, self.name)
        if self._legacy:
            from whisperjav_tpu_torch.models.enhancement.zipnet import denoise
        else:
            from whisperjav_tpu_torch.models.enhancement.zipenhancer import (
                denoise,
            )

        def run(clip: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.ascontiguousarray(clip[None], np.float32))
            return denoise(self._model, x.to(self.device), chunk)[0].cpu() \
                .numpy()

        out = chunked_crossfade(audio, chunk, fade, run)
        return EnhancementResult(out, sample_rate, True, self.name,
                                 {"chunks": int(np.ceil(len(audio)
                                                        / max(chunk - fade,
                                                              1)))})
