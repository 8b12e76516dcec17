"""Build a ready-to-run pipeline on one device from a resolved
PipelineConfig (counterpart of ``whisperjav_tpu/pipelines/factory.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from whisperjav_tpu.config.presets import (
    PipelineConfig, resolve_pipeline_config,
)
from whisperjav_tpu.models.whisper.alignment_heads import (
    resolve_alignment_heads,
)
from whisperjav_tpu.models.whisper.config import WHISPER_SIZES
from whisperjav_tpu.models.whisper.tokenizer import (
    WhisperTokenizer, find_tokenizer_files,
)
from whisperjav_tpu.utils.logger import logger
from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
from whisperjav_tpu_torch.models.whisper.weights import (
    init_params, load_checkpoint,
)
from whisperjav_tpu_torch.pipelines.engine import (
    QualityThresholds, TranscriptionEngine, resolve_device,
)
from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline


def load_model(model_name: str, checkpoint: Optional[str] = None,
               device="cuda", dtype: torch.dtype = torch.bfloat16):
    """Whisper weights on ``device``: a local Hugging Face checkpoint when
    given, otherwise a random init of the named size drawn from a
    generator seeded 0 (decoding then gives well-formed but meaningless
    text)."""
    dev = resolve_device(device)
    if checkpoint:
        config, model = load_checkpoint(checkpoint, dtype=dtype, device=dev)
        logger.info("loaded checkpoint %s (%s)", checkpoint, config.name)
        return config, model
    if model_name not in WHISPER_SIZES:
        raise ValueError(f"unknown model {model_name!r}; "
                         f"choose from {sorted(WHISPER_SIZES)}")
    config = WHISPER_SIZES[model_name]
    heads = resolve_alignment_heads(model_name, config.n_text_layer,
                                    config.n_text_head)
    if heads:
        config = dataclasses.replace(config, alignment_heads=heads)
    logger.warning("no checkpoint provided — using random-init %s weights "
                   "(text output will not be meaningful)", model_name)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    return config, init_params(config, generator, dtype=dtype, device=dev)


def ladder(temperatures) -> tuple:
    """A sensitivity's temperatures, extended by 0.4..1.0 past its top."""
    return tuple(temperatures) + tuple(
        t for t in (0.4, 0.6, 0.8, 1.0) if t > max(temperatures))


def build_pipeline(
    cfg: Optional[PipelineConfig] = None,
    checkpoint: Optional[str] = None,
    postprocessor=None,
    device="cuda",
) -> TranscribePipeline:
    """The file pipeline for ``cfg`` (default: the flagless balanced
    mode and sensitivity) on one device, computing in bf16, with int8
    decoder weights when ``cfg.int8_weights``."""
    if cfg is None:
        cfg = resolve_pipeline_config()
    model_config, model = load_model(cfg.model, checkpoint, device=device)
    sens = cfg.sensitivity
    options = DecodeOptions(
        task=cfg.task,
        language=cfg.language,
        with_timestamps=cfg.mode.with_timestamps and not cfg.no_timestamps,
        repetition_penalty=sens.repetition_penalty,
        no_repeat_ngram_size=sens.no_repeat_ngram_size,
        beam_size=sens.beam_size,
        patience=sens.patience,
        best_of=sens.best_of,
        cross_kv_int8=True,
    )
    thresholds = QualityThresholds(
        logprob_threshold=sens.logprob_threshold,
        no_speech_threshold=sens.no_speech_threshold,
        compression_ratio_threshold=sens.compression_ratio_threshold,
        temperatures=ladder(sens.temperatures),
    )
    tokenizer = WhisperTokenizer(model_config,
                                 find_tokenizer_files(checkpoint))
    prompt_tokens: tuple = ()
    if cfg.initial_prompt:
        prompt_tokens = tuple(tokenizer.encode(cfg.initial_prompt))[-200:]
        if not tokenizer.is_real:
            logger.warning("--prompt set without a real tokenizer; prompt "
                           "conditioning uses fallback token ids")
    engine = TranscriptionEngine(
        model_config, model, options=options, thresholds=thresholds,
        batch_size=cfg.batch_size, device=device, tokenizer=tokenizer,
        prompt_tokens=prompt_tokens, int8_weights=cfg.int8_weights)
    vad_kwargs = dict(cfg.vad_kwargs)
    if cfg.mode.vad_backend == "energy":
        vad_kwargs.setdefault("energy_db", sens.energy_vad_db)
        vad_kwargs.setdefault("max_group_duration_s",
                              sens.max_group_duration_s)
    elif cfg.mode.vad_backend in ("silero", "silero-jax"):
        vad_kwargs.setdefault("threshold", sens.vad_threshold)
        vad_kwargs.setdefault("max_group_duration_s",
                              sens.max_group_duration_s)
    return TranscribePipeline(
        engine,
        scene_backend=cfg.mode.scene_backend,
        vad_backend=cfg.mode.vad_backend,
        scene_kwargs=cfg.scene_kwargs,
        vad_kwargs=vad_kwargs,
        language=cfg.language,
        postprocessor=postprocessor,
        pack=cfg.pack_windows,
        keep_intermediates=cfg.keep_intermediates,
    )
