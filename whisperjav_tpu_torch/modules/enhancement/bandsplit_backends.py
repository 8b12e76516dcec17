"""Heavy enhancement backends, BS-RoFormer and ClearVoice, on a torch
device.

Counterpart of ``whisperjav_tpu/modules/enhancement/bandsplit_backends.py``:

- ``bs-roformer``: vocal isolation at 44.1 kHz on the checkpoint-faithful
  band-split RoFormer (``models/enhancement/bs_roformer.py``);
- ``clearvoice``: the reference's ClearVoice menu, picked by ``model=``:
  ``FRCRN_SE_16K`` (complex U-Net + FSMN, 16 kHz) or
  ``MossFormer2_SE_48K`` (the default, 48 kHz); a file that is not a
  MossFormer2 checkpoint loads as the legacy band-split ``.npz`` tree.

Audio is resampled on the host to the model's rate, run in 8 s chunks
with a 0.5 s crossfade (``chunked_crossfade``), one chunk at a time on
``device``, and resampled back. Both declare ``is_lightweight=False``.

Without a usable weights file a backend warns and passes audio through
with success=False, as the JAX package does. The file is read into host
tensors inside that guard; the model moves to ``device`` outside it, so a
device failure raises instead of turning into a passthrough.
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


@dataclass
class _HeavyConfig:
    weights: Optional[str] = None
    model: Optional[str] = None
    chunk_s: float = 8.0
    crossfade_s: float = 0.5


class _ChunkedModelBackend:
    """Shared resample -> chunk -> model -> crossfade -> resample
    plumbing."""

    name = "heavy"
    is_lightweight = False
    sample_rate = 16_000

    def __init__(self, device="cuda", **kwargs):
        self.config = _HeavyConfig(**kwargs)
        self.device = torch.device(device)
        self._model = None
        if self.config.weights:
            try:
                model = self._load(self.config.weights)
            except Exception as e:  # the file: degrade, never break the run
                logger.warning("%s: failed to load %s (%s)", self.name,
                               self.config.weights, e)
            else:
                self._model = model.to(self.device)
                logger.info("%s: loaded %s weights from %s on %s",
                            self.name, self._engine, self.config.weights,
                            self.device)

    def get_preferred_sample_rate(self) -> int:
        return self.sample_rate

    def _load(self, path: str) -> torch.nn.Module:
        """Read ``path`` into a model on the CPU."""
        raise NotImplementedError

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """One chunk (1, n) on the device -> (1, n)."""
        raise NotImplementedError

    def _apply(self, clip: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(clip[None], np.float32))
        return self._run(x.to(self.device))[0].cpu().numpy()

    def enhance(self, audio: np.ndarray,
                sample_rate: int) -> EnhancementResult:
        if self._model is None:
            return EnhancementResult(audio, sample_rate, False, self.name,
                                     {"reason": "no weights loaded"})
        from whisperjav_tpu_torch.modules.audio_io import resample

        sr = self.sample_rate
        work = (resample(audio, sample_rate, sr)
                if sample_rate != sr else audio)
        if len(work) == 0:
            return EnhancementResult(audio, sample_rate, True, self.name)
        chunk = int(self.config.chunk_s * sr)
        fade = int(self.config.crossfade_s * sr)
        out = chunked_crossfade(work, chunk, fade, self._apply)
        if sample_rate != sr:
            out = resample(out, sr, sample_rate)
            out = out[:len(audio)]
        return EnhancementResult(out.astype(np.float32), sample_rate,
                                 True, self.name, {"engine": self._engine})


class BsRoformerBackend(_ChunkedModelBackend):
    """Checkpoint-faithful BS-RoFormer vocal isolation at 44.1 kHz."""

    name = "bs-roformer"
    sample_rate = 44_100

    def _load(self, path: str) -> torch.nn.Module:
        from whisperjav_tpu_torch.models.enhancement import bs_roformer

        model, cfg = bs_roformer.load_checkpoint(path)
        self.sample_rate = cfg.sample_rate
        self._engine = "bs_roformer"
        return model

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        from whisperjav_tpu_torch.models.enhancement import bs_roformer

        return bs_roformer.isolate_vocals(self._model, x)


class ClearVoiceBackend(_ChunkedModelBackend):
    """ClearVoice model menu; the engine is picked by ``model=``."""

    name = "clearvoice"
    sample_rate = 48_000
    DEFAULT_MODEL = "MossFormer2_SE_48K"     # the reference's default

    def __init__(self, device="cuda", **kwargs):
        model = kwargs.get("model") or self.DEFAULT_MODEL
        if model.upper().startswith("FRCRN"):
            self.sample_rate = 16_000
        super().__init__(device=device, **kwargs)

    def _load(self, path: str) -> torch.nn.Module:
        model = (self.config.model or self.DEFAULT_MODEL).upper()
        if model.startswith("FRCRN"):
            from whisperjav_tpu_torch.models.enhancement import frcrn

            net, _ = frcrn.load_checkpoint(path)
            self.sample_rate = 16_000
            self._engine = "frcrn"
            return net
        from whisperjav_tpu_torch.models.enhancement import mossformer2

        try:
            net, cfg = mossformer2.load_checkpoint(path)
        except Exception:
            # legacy .npz trees of the band-split stand-in still load
            from whisperjav_tpu_torch.models.enhancement import bandsplit

            net = bandsplit.load_params(path, bandsplit.BandSplitConfig(
                sample_rate=48_000, target="noise", n_bands=20, n_layers=3))
            self._engine = "bandsplit"
            return net
        self.sample_rate = cfg.sample_rate
        self._engine = "mossformer2"
        return net

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        from whisperjav_tpu_torch.models.enhancement import (
            bandsplit, frcrn, mossformer2,
        )

        if self._engine == "frcrn":
            return frcrn.denoise(self._model, x)
        if self._engine == "mossformer2":
            return mossformer2.enhance(self._model, x, x.shape[-1])
        return bandsplit.apply(self._model, x, x.shape[-1])
