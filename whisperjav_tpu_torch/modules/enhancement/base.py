"""Speech enhancement framework: protocol, negotiation, graceful failure.

The port's copy of ``whisperjav_tpu/modules/enhancement/base.py``. The
network backends (the ZipEnhancer, ``bs-roformer`` and ``clearvoice``)
run on a torch device (``device`` in :func:`create_enhancer`).

Contract parity with the reference's enhancement framework (reference:
whisperjav/modules/speech_enhancement/base.py:117-380 — sample-rate
negotiation via get_preferred_sample_rate, graceful degradation (any
failure returns the ORIGINAL audio with success=False; enhancement must
never break the pipeline), is_lightweight resource hint, and the
pipeline helpers enhance_scenes / get_extraction_sample_rate /
is_passthrough_backend from speech_enhancement/__init__.py:58-68).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class EnhancementResult:
    audio: np.ndarray
    sample_rate: int
    success: bool
    backend: str
    stats: Dict = field(default_factory=dict)


@runtime_checkable
class SpeechEnhancer(Protocol):
    name: str
    is_lightweight: bool

    def get_preferred_sample_rate(self) -> int: ...

    def enhance(self, audio: np.ndarray,
                sample_rate: int) -> EnhancementResult: ...


class PassthroughEnhancer:
    name = "none"
    is_lightweight = True

    def get_preferred_sample_rate(self) -> int:
        return 16_000

    def enhance(self, audio, sample_rate) -> EnhancementResult:
        return EnhancementResult(audio, sample_rate, True, self.name)


_PASSTHROUGH = {"none", "null", "passthrough", "", None}


def is_passthrough_backend(backend: Optional[str]) -> bool:
    return backend in _PASSTHROUGH or (
        isinstance(backend, str) and backend.lower() in _PASSTHROUGH)


def create_enhancer(backend: Optional[str] = "none", device="cuda",
                    **kwargs) -> SpeechEnhancer:
    """The enhancer for ``backend``; the networks run on ``device``."""
    b = (backend or "none").lower()
    if is_passthrough_backend(b):
        return PassthroughEnhancer()
    if b in ("dsp", "ffmpeg-dsp", "filters"):
        from whisperjav_tpu_torch.modules.enhancement.dsp import DspEnhancer
        return DspEnhancer(**kwargs)
    if b in ("zipenhancer", "zip", "denoise"):
        from whisperjav_tpu_torch.modules.enhancement.zipenhancer import (
            ZipEnhancer,
        )
        return ZipEnhancer(device=device, **kwargs)
    if b in ("bs-roformer", "bsroformer", "vocals", "clearvoice",
             "mossformer"):
        from whisperjav_tpu_torch.modules.enhancement import (
            bandsplit_backends as heavy,
        )
        cls = (heavy.ClearVoiceBackend if b in ("clearvoice", "mossformer")
               else heavy.BsRoformerBackend)
        return cls(device=device, **kwargs)
    logger.warning("unknown enhancer backend %r; using passthrough", backend)
    return PassthroughEnhancer()


def get_extraction_sample_rate(backend: Optional[str]) -> int:
    """Negotiate the extraction rate with the configured enhancer
    (reference: balanced_pipeline.py:172-175 extracts 48 kHz for real
    enhancers): 44.1 kHz for bs-roformer, 48 kHz for clearvoice, 16 kHz
    for the others."""
    if is_passthrough_backend(backend):
        return 16_000
    return create_enhancer(backend).get_preferred_sample_rate()


def chunked_crossfade(
    audio: np.ndarray,
    chunk: int,
    fade: int,
    apply_fn,
) -> np.ndarray:
    """Process long audio in overlapping chunks with linear crossfade.

    ``apply_fn(clip)`` maps a fixed-length chunk (zero-padded at the tail)
    to processed samples of the same length. Shared by every chunked
    enhancement backend so the zero-fade guard and weight normalization
    stay uniform.
    """
    n = len(audio)
    if n == 0:
        return audio
    fade = max(min(fade, chunk - 1), 0)
    hop = max(chunk - fade, 1)
    out = np.zeros(n, np.float32)
    weight = np.zeros(n, np.float32)
    ramp = np.linspace(0.0, 1.0, max(fade, 1), dtype=np.float32)
    for start in range(0, n, hop):
        clip = audio[start:start + chunk]
        pad = chunk - len(clip)
        if pad:
            clip = np.pad(clip, (0, pad))
        den = np.asarray(apply_fn(clip), np.float32)
        if pad:
            den = den[:chunk - pad]
        w = np.ones(len(den), np.float32)
        if fade and start > 0 and len(den) >= fade:
            w[:fade] = ramp
        if fade and start + chunk < n and len(den) >= fade:
            w[-fade:] = ramp[::-1]
        out[start:start + len(den)] += den * w
        weight[start:start + len(den)] += w
        if start + chunk >= n:
            break
    return out / np.maximum(weight, 1e-8)


def enhance_scenes(
    enhancer: SpeechEnhancer,
    scene_audios: Sequence[np.ndarray],
    sample_rate: int,
) -> List[EnhancementResult]:
    """Enhance each scene with the graceful-degradation guarantee."""
    results = []
    for i, audio in enumerate(scene_audios):
        try:
            results.append(enhancer.enhance(audio, sample_rate))
        except Exception as e:  # noqa: BLE001 — contract: never fail the run
            logger.warning("enhancement failed on scene %d (%s); "
                           "using original audio", i, e)
            results.append(EnhancementResult(audio, sample_rate, False,
                                             enhancer.name,
                                             {"error": str(e)}))
    return results
