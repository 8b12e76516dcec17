"""Build a ready-to-run pipeline from a resolved PipelineConfig
(counterpart of ``whisperjav_tpu/pipelines/factory.py``): on one card by
default, window batches split data-parallel over the first ``devices``
cards when asked (``parallel/mesh.py``)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from whisperjav_tpu_torch.config.presets import (
    PipelineConfig, resolve_pipeline_config,
)
from whisperjav_tpu_torch.models.whisper.alignment_heads import (
    resolve_alignment_heads,
)
from whisperjav_tpu_torch.models.whisper.config import WHISPER_SIZES
from whisperjav_tpu_torch.models.whisper.tokenizer import (
    WhisperTokenizer, find_tokenizer_files,
)
from whisperjav_tpu_torch.utils.logger import logger
from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
from whisperjav_tpu_torch.models.whisper.vocab_subset import (
    ja_text_ids, synthetic_text_ids,
)
from whisperjav_tpu_torch.models.whisper.weights import (
    init_params, load_checkpoint,
)
from whisperjav_tpu_torch.pipelines.engine import (
    QualityThresholds, TranscriptionEngine, resolve_device,
)
from whisperjav_tpu_torch.parallel.mesh import Mesh, mesh_for, padded_batch
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


def vocab_subset(vocab_slice: Optional[str], tokenizer: WhisperTokenizer,
                 config) -> Optional[np.ndarray]:
    """The kept text ids of ``--vocab-slice``, or of ``WJAV_VOCAB_SLICE``
    when the flag is not given (the JAX factory's precedence): "ja"
    derives the JA-plausible subset from a real tokenizer (None, with a
    warning, without one); a positive integer is the synthetic subset of
    that size; unset or 0 keeps the full vocabulary."""
    vs = str(vocab_slice or os.environ.get("WJAV_VOCAB_SLICE", ""))
    if vs == "ja":
        keep = ja_text_ids(tokenizer, config)
        if keep is None:
            logger.warning("--vocab-slice ja needs a real tokenizer "
                           "(checkpoint vocab); decoding the full vocab")
        else:
            logger.info("vocab slice: %d/%d text ids kept", len(keep),
                        config.eot)
        return keep
    if vs.isdigit() and int(vs) > 0:
        return synthetic_text_ids(config, int(vs))
    return None


def build_engine(cfg: PipelineConfig, checkpoint: Optional[str] = None,
                 device="cuda") -> TranscriptionEngine:
    """A bare engine (no scene or VAD pipeline around it), for a Whisper
    model in the generator role of the decoupled stack (the anime-whisper
    slot): text only, greedy at T=0 with the sensitivity's repetition
    penalty, bf16 on ``device``."""
    model_config, model = load_model(cfg.model, checkpoint, device=device)
    sens = cfg.sensitivity
    options = DecodeOptions(
        task=cfg.task, language=cfg.language,
        with_timestamps=False,
        repetition_penalty=sens.repetition_penalty,
        cross_kv_int8=True,
    )
    tokenizer = WhisperTokenizer(model_config,
                                 find_tokenizer_files(checkpoint))
    return TranscriptionEngine(
        model_config, model, options=options,
        thresholds=QualityThresholds(temperatures=(0.0,)),
        batch_size=cfg.batch_size, device=device, tokenizer=tokenizer)


def build_pipeline(
    cfg: Optional[PipelineConfig] = None,
    checkpoint: Optional[str] = None,
    postprocessor=None,
    device="cuda",
    tracer=None,
    devices: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> TranscribePipeline:
    """The file pipeline for ``cfg`` (default: the flagless balanced
    mode and sensitivity), computing in bf16, with int8
    decoder weights when ``cfg.int8_weights``, word alignment when
    ``cfg.word_timestamps``, a sliced vocabulary for ``cfg.vocab_slice``
    ("ja": the JA-plausible ids of a real tokenizer; an integer: that
    many evenly spaced text ids), the enhancer ``cfg.enhancer_backend`` on
    the same device, and overlapped chunks instead of scenes and VAD in
    transformers mode; ``tracer`` receives the pipeline's events.

    The engine runs on one device unless ``devices`` asks for more: it
    then shards its window batches data-parallel over the first
    ``devices`` cards, capped at the cards there are
    (``parallel/mesh.mesh_for``, which raises DevicesConflict for
    ``devices`` above 1 with ``device`` naming a card by its index; the
    JAX factory shards over every device by default). ``mesh`` names
    the devices outright, a hook for tests and the on-card smoke run.
    Over N devices ``cfg.batch_size`` is padded up to a multiple of N,
    in place, as in the JAX factory; an explicit ``mesh`` is padded for
    too, where the JAX factory leaves that to the caller."""
    if cfg is None:
        cfg = resolve_pipeline_config()
    if mesh is None:
        mesh = mesh_for(device, devices)
    if mesh is not None:
        if mesh.size > 1:
            cfg.batch_size = padded_batch(cfg.batch_size, mesh.size)
        device = mesh.devices[0]
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
    # WJAV_LADDER_RUNGS=N keeps the ladder's first N rungs (0 or unset:
    # all), the JAX factory's measurement knob: random weights fail every
    # gate and would run every rung
    temperatures = ladder(sens.temperatures)
    rungs = int(os.environ.get("WJAV_LADDER_RUNGS", "0"))
    if rungs > 0:
        temperatures = temperatures[:rungs]
    thresholds = QualityThresholds(
        logprob_threshold=sens.logprob_threshold,
        no_speech_threshold=sens.no_speech_threshold,
        compression_ratio_threshold=sens.compression_ratio_threshold,
        temperatures=temperatures,
    )
    # the JAX factory's memory guard, per card: large-v2-class widths
    # above 64 effective decode rows (batch x beams) a card
    n_chips = mesh.size if mesh is not None else 1
    effective_rows = cfg.batch_size * max(sens.beam_size, 1) // n_chips
    if model_config.n_audio_state >= 1280 and effective_rows > 64:
        logger.warning(
            "batch_size(%d) x beam_size(%d) / %d chips = %d effective "
            "decode rows per chip may exceed HBM for %s; consider "
            "--batch-size %d",
            cfg.batch_size, sens.beam_size, n_chips, effective_rows,
            model_config.name,
            max(64 * n_chips // max(sens.beam_size, 1), 1))
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
        prompt_tokens=prompt_tokens, int8_weights=cfg.int8_weights,
        word_timestamps=cfg.word_timestamps,
        vocab_subset=vocab_subset(cfg.vocab_slice, tokenizer, model_config),
        mesh=mesh)
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
        enhancer_backend=cfg.enhancer_backend,
        enhancer_kwargs=cfg.enhancer_kwargs,
        postprocessor=postprocessor,
        tracer=tracer,
        pack=cfg.pack_windows,
        chunked=cfg.mode.name == "transformers",
        chunk_s=cfg.chunk_s,
        chunk_overlap_s=cfg.chunk_overlap_s,
        enhance_for_vad=cfg.enhance_for_vad,
        keep_intermediates=cfg.keep_intermediates,
    )
