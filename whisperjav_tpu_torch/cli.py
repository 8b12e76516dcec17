"""``whisperjav-torch``: the ``whisperjav`` command line on the PyTorch port.

Flags and defaults are the JAX package's own (``cli_args`` is the port's
copy of ``whisperjav_tpu/cli.py``'s parser), so a flagless run is
balanced mode at balanced sensitivity: turbo, energy scenes,
silero-calibrated VAD, batch 32, beam 2 with the temperature ladder. ``--device`` picks the
device (default ``cuda``; a CUDA device that is not there is an error).

``--int8-weights`` runs the decoder on int8 weights through the fused
decode blocks; the faster-whisper spelling ``--compute-type int8*``
turns it on and ``float*`` off, as in the JAX CLI. ``--mode fidelity``
(large-v2, every scene denoised by the ZipEnhancer: weights from
``--enhancer-weights``, passed through without), ``--mode transformers``
(overlapped 30 s / 5 s chunks; the ``--hf-*`` flags as the JAX CLI maps
them) and ``--mode anime`` run as in the JAX CLI, with
``--word-timestamps``, ``--vocab-slice``, ``--enhancer`` (zipenhancer,
dsp, bs-roformer, clearvoice: MossFormer2_SE_48K, or FRCRN_SE_16K with
``--enhancer-arg model=FRCRN_SE_16K``; none), ``--enhancer-arg`` and
``--enhance-for-vad``. ``--mode qwen`` runs the decoupled subtitle
pipeline (semantic scenes, the whisperseg VAD-grouped framer, the
Qwen3-ASR generator on an int8 LM, the forced aligner) with the JAX
CLI's framer, generator, cleaner, aligner, step-down, hardening, context
and ``--qwen-*`` flags; as in the JAX CLI, ``--qwen-enhancer-model``
does not reach the qwen-mode enhancer, which then passes audio through.

The VAD networks run on the device with ``--vad-arg weights=<.npz>``
(silero, whisperseg, ten) and ``--vad-backend whisper-vad``; ``--daemon``
routes the files through a resident ``whisperjav-torch-serve`` engine
(autostarted on ``--device``), and ``--daemon-stop`` stops it.

``--multihost`` (``--coordinator``, ``--num-hosts``, ``--host-id``)
splits the discovered files over processes that meet at a gloo
rendezvous; one that is asked for and fails exits 1.

The file pipeline runs on one card; ``--devices N`` shards its window
batches data-parallel over the first N cards (``parallel/mesh.py``),
capped at the cards there are. The JAX CLI shards over every device by
default; here the mesh is opt-in, since its shards run slower than one
card alone (PERF.md §6). Like the JAX CLI, the port reads the flag only
where it builds that pipeline (which ``--async-processing`` decodes on
too): ``--daemon``, ``--ensemble`` and qwen mode do not read it.
``--devices`` above 1 with ``--device cuda:<k>`` exits 2.

A mode the port does not cover exits with "not ported yet" before any
work.

    whisperjav-torch clip.wav --output-dir out/
    whisperjav-torch clip.wav --model large-v2 --int8-weights
    whisperjav-torch clip.wav --mode fidelity --enhancer-weights zip.npz \
        --word-timestamps
    whisperjav-torch clip.wav --enhancer clearvoice --enhancer-weights mf2.npz
    whisperjav-torch clip.wav --mode qwen
    whisperjav-torch a.wav b.wav --daemon --daemon-port 8479
    whisperjav-torch --daemon-stop --daemon-port 8479
    whisperjav-torch /data --multihost --coordinator host0:8476 \
        --num-hosts 2 --host-id 0 --skip-existing
    python -m whisperjav_tpu_torch.cli clip.wav --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from whisperjav_tpu_torch.cli_args import (
    _ASR_TO_MODE, _FEATURE_TO_SCENE, _json_flag, _parse_kv_args,
    _pass_overrides, parse_arguments,
)

PORTED_MODES = ("faster", "fast", "balanced", "fidelity", "transformers",
                "anime", "qwen")


def _unported(args) -> List[str]:
    """Every requested flag, mode or backend the port does not run."""
    out = []
    if args.mode not in PORTED_MODES:
        out.append(f"--mode {args.mode}")
    return out


def _qwen_overrides(args, overrides: Dict) -> Optional[str]:
    """The ``--qwen-*`` config flags into ``overrides``, in place, as the
    JAX CLI maps them; returns ``--qwen-sensitivity``."""
    from whisperjav_tpu_torch.utils.logger import logger
    for dest, key in (("qwen_batch_size", "batch_size"),
                      ("qwen_max_group_duration", "max_group_duration_s"),
                      ("qwen_vad_threshold", "vad_threshold")):
        if getattr(args, dest) is not None:
            overrides[key] = getattr(args, dest)
    for dest, key in (("qwen_scene", "scene_backend"),
                      ("qwen_segmenter", "vad_backend"),
                      ("qwen_enhancer", "enhancer_backend"),
                      ("qwen_model_id", "model")):
        if getattr(args, dest):
            overrides[key] = getattr(args, dest)
    if args.qwen_enhancer_model:
        overrides["enhancer_kwargs"] = {
            **(overrides.get("enhancer_kwargs") or {}),
            "weights": args.qwen_enhancer_model}
    if args.qwen_language:
        lang_map = {"japanese": "ja", "english": "en", "chinese": "zh",
                    "korean": "ko"}
        overrides["language"] = lang_map.get(args.qwen_language.lower(),
                                             args.qwen_language)
    if args.qwen_input_mode in ("context_aware", "vad_slicing"):
        logger.warning("--qwen-input-mode %s is a deprecated alias of "
                       "'assembly' (reference: main.py:566-568); using "
                       "assembly", args.qwen_input_mode)
    if args.qwen_japanese_postprocess:
        logger.warning("--qwen-japanese-postprocess has no effect for qwen "
                       "mode (AssemblyTextCleaner covers it)")
    return args.qwen_sensitivity


def _qwen_pipeline(args, cfg, checkpoint: Optional[str], device):
    """The decoupled qwen-mode pipeline for the resolved ``cfg`` and the
    stack flags (framer, generator, cleaner, aligner, step-down,
    hardening, context, token budgets, scene clamps), on ``device``; the
    JAX CLI's qwen branch."""
    from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
        CohereStyleGenerator, QwenGenerator, WhisperGenerator,
        create_aligner, create_cleaner, create_framer,
    )
    from whisperjav_tpu_torch.modules.subtitle_pipeline.orchestrator import (
        DecoupledSubtitlePipeline,
    )
    from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
        HardeningConfig, RegroupMode, StepDownConfig, TimestampMode,
    )
    from whisperjav_tpu_torch.pipelines.qwen import QwenPipeline
    from whisperjav_tpu_torch.utils.logger import logger
    model_size = (cfg.model if cfg.model.startswith("qwen")
                  else "qwen3-asr-1.7b")
    framer_kwargs: Dict = {}
    framer_name = args.framer or "vad-grouped"
    if framer_name == "vad-grouped":
        framer_kwargs["vad_backend"] = cfg.mode.vad_backend
        framer_kwargs["device"] = device
        if args.qwen_vad_threshold is not None:
            framer_kwargs["threshold"] = args.qwen_vad_threshold
        if args.qwen_chunk_threshold is not None:
            framer_kwargs["max_gap_s"] = args.qwen_chunk_threshold
        if args.qwen_vad_padding is not None:
            pad_s = args.qwen_vad_padding / 1000.0
            framer_kwargs["pad_start_s"] = pad_s
            framer_kwargs["pad_end_s"] = pad_s
        if cfg.vad_kwargs:
            framer_kwargs.update(cfg.vad_kwargs)
    elif framer_name == "srt-source":
        if not args.framer_srt_path:
            raise SystemExit("--framer srt-source requires --framer-srt-path")
        framer_kwargs["srt_path"] = args.framer_srt_path
    framer_kwargs.update(_json_flag(args.framer_config, "--framer-config"))
    framer = create_framer(framer_name, **framer_kwargs)
    step_down = StepDownConfig(enabled=not args.no_step_down)
    if args.step_down_attempts is not None:
        step_down = StepDownConfig(
            enabled=step_down.enabled and args.step_down_attempts > 0,
            fallback_max_group_s=step_down.fallback_max_group_s,
            max_retries=max(args.step_down_attempts, 0))
    if args.step_down_max_group is not None:
        step_down = StepDownConfig(
            enabled=step_down.enabled,
            fallback_max_group_s=args.step_down_max_group,
            max_retries=step_down.max_retries)
    hardening = None
    if args.timestamp_mode:
        hardening = HardeningConfig(
            timestamp_mode=TimestampMode(args.timestamp_mode))
    context = args.context
    if args.context_file:
        try:
            file_ctx = Path(args.context_file).read_text(
                encoding="utf-8").strip()
        except OSError as e:
            raise SystemExit(f"--context-file: {e}")
        context = f"{context}\n{file_ctx}" if context else file_ctx
    gen_kwargs: Dict = {}
    if args.qwen_repetition_penalty is not None:
        gen_kwargs["repetition_penalty"] = args.qwen_repetition_penalty
    if context:
        gen_kwargs["context"] = context
    if args.qwen_max_tokens is not None:
        gen_kwargs["max_tokens"] = args.qwen_max_tokens
    if args.qwen_max_tokens_per_second is not None:
        gen_kwargs["max_tokens_per_second"] = args.qwen_max_tokens_per_second
    gen_kwargs.update(_json_flag(args.generator_config,
                                 "--generator-config"))
    if args.generator == "anime-whisper":
        # a Whisper fine-tune decoded without prompts; any local Whisper
        # checkpoint slots in
        import copy
        from whisperjav_tpu_torch.pipelines.factory import build_engine
        wcfg = copy.copy(cfg)
        if wcfg.model.startswith("qwen"):
            wcfg.model = args.model or "small"
        generator = WhisperGenerator(engine=build_engine(
            wcfg, checkpoint=checkpoint, device=device))
    elif args.generator == "cohere":
        dropped = [name for key, name in
                   (("repetition_penalty", "--qwen-repetition-penalty"),
                    ("context", "--context/--context-file"))
                   if gen_kwargs.pop(key, None) is not None]
        if dropped:
            logger.warning("--generator cohere does not support %s; "
                           "ignoring (the cohere slot is greedy and "
                           "prompt-free)", " and ".join(dropped))
        if "max_tokens" in gen_kwargs:
            gen_kwargs["max_new_tokens"] = gen_kwargs.pop("max_tokens")
        if "model_id" in gen_kwargs:
            model_size = gen_kwargs.pop("model_id")
        generator = CohereStyleGenerator(
            model_size=model_size, batch_size=cfg.batch_size,
            checkpoint=checkpoint, device=device, **gen_kwargs)
    else:
        if "model_id" in gen_kwargs:    # reference config-key spelling
            model_size = gen_kwargs.pop("model_id")
        generator = QwenGenerator(model_size=model_size,
                                  batch_size=cfg.batch_size,
                                  checkpoint=checkpoint, device=device,
                                  **gen_kwargs)
    cleaner_name = args.cleaner or (
        "assembly" if args.qwen_assembly_cleaner else "passthrough")
    cleaner = create_cleaner(cleaner_name, **_json_flag(
        args.cleaner_config, "--cleaner-config"))
    aligner_name = args.aligner or (
        "none" if args.qwen_timestamps == "none" else "qwen3")
    aligner = create_aligner(aligner_name, **{
        "device": device,
        **_json_flag(args.aligner_config, "--aligner-config")})
    max_group_s = (args.qwen_stepdown_initial_group
                   if args.qwen_stepdown_initial_group is not None
                   else cfg.sensitivity.max_group_duration_s)
    decoupled = DecoupledSubtitlePipeline(
        framer=framer, generator=generator, cleaner=cleaner,
        aligner=aligner, max_group_s=max_group_s, step_down=step_down,
        hardening=hardening,
        regroup_mode=(RegroupMode(args.regroup_mode)
                      if args.regroup_mode else RegroupMode.STANDARD))
    pipe_kwargs: Dict = {"safe_chunking": args.qwen_safe_chunking}
    if args.qwen_scene_min_duration is not None:
        pipe_kwargs["scene_min_s"] = args.qwen_scene_min_duration
    if args.qwen_scene_max_duration is not None:
        pipe_kwargs["scene_max_s"] = args.qwen_scene_max_duration
    return QwenPipeline(decoupled, scene_backend=cfg.mode.scene_backend,
                        scene_kwargs=cfg.scene_kwargs or None,
                        enhancer_backend=cfg.enhancer_backend,
                        language=cfg.language, device=device, **pipe_kwargs)


def _qwen_deep_flags(args) -> List[str]:
    """Qwen stack-level knobs the resident engine's default decoupled
    stack (pipelines/qwen_factory.py) cannot receive. Any of them set
    makes a ``--daemon`` invocation fall back in-process; cfg-level
    overrides (scene/VAD/sensitivity fields) are separately caught by
    the full-config fingerprint hash (daemon_client.daemon_reproducible)."""
    checks = [
        ("--timestamp-mode", args.timestamp_mode is not None),
        ("--regroup-mode", args.regroup_mode is not None),
        ("--no-step-down", args.no_step_down),
        ("--step-down-attempts", args.step_down_attempts is not None),
        ("--step-down-max-group", args.step_down_max_group is not None),
        ("--qwen-stepdown-initial-group",
         args.qwen_stepdown_initial_group is not None),
        ("--framer", args.framer is not None),
        ("--framer-srt-path", args.framer_srt_path is not None),
        ("--framer-config", args.framer_config is not None),
        ("--generator", args.generator is not None),
        ("--generator-config", args.generator_config is not None),
        ("--cleaner", args.cleaner is not None),
        ("--cleaner-config", args.cleaner_config is not None),
        ("--aligner", args.aligner is not None),
        ("--aligner-config", args.aligner_config is not None),
        ("--context", args.context is not None),
        ("--context-file", args.context_file is not None),
        ("--qwen-repetition-penalty",
         args.qwen_repetition_penalty is not None),
        ("--qwen-max-tokens", args.qwen_max_tokens is not None),
        ("--qwen-max-tokens-per-second",
         args.qwen_max_tokens_per_second is not None),
        ("--qwen-chunk-threshold", args.qwen_chunk_threshold is not None),
        ("--qwen-vad-padding", args.qwen_vad_padding is not None),
        ("--qwen-timestamps", args.qwen_timestamps is not None),
        ("--no-qwen-safe-chunking", not args.qwen_safe_chunking),
        ("--qwen-scene-min-duration",
         args.qwen_scene_min_duration is not None),
        ("--qwen-scene-max-duration",
         args.qwen_scene_max_duration is not None),
        ("--no-qwen-assembly-cleaner", not args.qwen_assembly_cleaner),
    ]
    return [name for name, is_set in checks if is_set]


def _daemon_stop(port: int) -> int:
    """Stop the resident engine; rc 0 when the port ends up free."""
    from whisperjav_tpu_torch.pipelines.daemon_client import (
        _health, stop_daemon,
    )
    from whisperjav_tpu_torch.utils.logger import logger
    if _health(port) is None:
        logger.warning("no resident engine on port %d", port)
        return 1
    if stop_daemon(port):
        logger.info("resident engine on port %d stopped", port)
        return 0
    logger.warning("resident engine on port %d did not stop (it may "
                   "lack the /shutdown endpoint — kill its pid)", port)
    return 1


def _daemon_batch(client, media, cfg, output_dir, out_lang: str,
                  finalize, stats_file: Optional[str], port: int,
                  tracer=None) -> int:
    """Each file through the resident engine: its SRT and metadata JSON
    written here (the per-file layout of the in-process path), then
    ``finalize`` (signatures, VTT). With a ``tracer`` (--trace-params)
    each file records the in-process path's events: ``file_start``
    before the request, ``segmentation`` and ``file_complete`` with the
    engine's stats after it (the JAX CLI records none under --daemon).
    Returns the exit code."""
    from whisperjav_tpu_torch.modules.media_discovery import (
        resolve_output_dir,
    )
    from whisperjav_tpu_torch.modules.srt import compose_srt
    from whisperjav_tpu_torch.utils.logger import logger
    batch_stats = []
    failures = 0
    t_start = time.time()
    for m in media:
        try:
            t0 = time.time()
            if tracer:
                tracer.event("file_start", {"file": str(m.path),
                                            "duration": m.duration or 0.0})
            subs, stats = client.transcribe(m.path)
            if tracer:
                tracer.event("segmentation", stats)
            out_dir = resolve_output_dir(output_dir, m)
            out_dir.mkdir(parents=True, exist_ok=True)
            srt_path = out_dir / f"{m.basename}.{out_lang}.whisperjav.srt"
            srt_path.write_text(compose_srt(subs), encoding="utf-8")
            finalize(srt_path)
            wall = time.time() - t0
            audio_s = float(stats.get("audio_s", 0.0) or 0.0)
            # the daemon's own stage walls stay inside stats; the
            # client-observed wall is what a --daemon user experiences
            stats = dict(stats)
            stats["daemon_client_wall_s"] = round(wall, 3)
            stats.setdefault("e2e_wall_s", round(wall, 3))
            stats["e2e_rtf_x"] = round(audio_s / max(wall, 1e-9), 2)
            stats.setdefault("final_subtitles", len(subs))
            meta = {"input": str(m.path), "pipeline": cfg.mode.name,
                    "duration_s": audio_s, "output": str(srt_path),
                    "stats": stats}
            # qwen daemon responses carry analytics/diagnostics; hoist
            # them to the in-process metadata layout
            for key in ("analytics", "scene_diagnostics"):
                if key in stats:
                    meta[key] = stats.pop(key)
            (out_dir / f"{m.basename}.whisperjav.json").write_text(
                json.dumps(meta, indent=2, default=str), encoding="utf-8")
            if tracer:
                tracer.event("file_complete", meta["stats"])
            logger.info("wrote %s (%d subtitles, daemon, RTF %.2fx)",
                        srt_path.name, len(subs),
                        audio_s / wall if wall > 0 else 0.0)
            batch_stats.append({"file": str(m.path),
                                "output": str(srt_path),
                                "wall_s": round(wall, 2), **stats})
        except Exception as e:  # keep the batch going
            logger.error("daemon transcribe failed on %s: %s",
                         m.path.name, e)
            failures += 1
    summary = {"files": len(media), "failures": failures,
               "wall_s": round(time.time() - t_start, 2),
               "daemon_port": port, "results": batch_stats}
    _write_summary(stats_file, summary)
    logger.info("done (daemon): %d file(s), %d failure(s), %.1fs",
                len(media), failures, summary["wall_s"])
    return 0 if failures == 0 else 2


def _translate_output(args, srt_path: Path, device) -> None:
    """Translate a written SRT with the ``--translate-*`` flags, as the JAX
    CLI does (tone, movie context, endpoint and API-key overrides, the
    Ollama context-window override, quiet mode); ``tpu-local`` runs its LM
    on ``device``."""
    import dataclasses
    import logging
    import os

    from whisperjav_tpu_torch.translate.providers import (
        max_batch_lines, resolve_provider,
    )
    from whisperjav_tpu_torch.translate.service import translate_srt
    from whisperjav_tpu_torch.translate.settings import movie_context_block

    if args.translate_api_key:
        pcfg = resolve_provider(args.translate,
                                base_url=args.translate_endpoint,
                                model=args.translate_model)
        if pcfg.api_key_env:
            os.environ[pcfg.api_key_env] = args.translate_api_key
    max_batch = None
    if args.ollama_num_ctx:
        pcfg = resolve_provider(args.translate,
                                base_url=args.translate_endpoint,
                                model=args.translate_model)
        max_batch = max_batch_lines(
            dataclasses.replace(pcfg, context_window=args.ollama_num_ctx))
    ctx = movie_context_block({
        "movie_title": args.translate_title,
        "movie_plot": args.translate_plot,
        "actress": args.translate_actress,
    })
    wj_logger = logging.getLogger("whisperjav_tpu")
    prev_level = wj_logger.level
    if args.translate_quiet:
        wj_logger.setLevel(logging.WARNING)
    try:
        translate_srt(srt_path, provider=args.translate,
                      model=args.translate_model,
                      target_language=args.translate_target,
                      base_url=args.translate_endpoint,
                      tone=args.translate_tone,
                      max_batch_size=max_batch,
                      movie_context=ctx, device=device)
    finally:
        if args.translate_quiet:
            wj_logger.setLevel(prev_level)


def _ensemble_configs(args, overrides: Dict, dot: Dict):
    """The two passes' configs, as the JAX CLI resolves them: the shared
    override set plus each pass's ``--passN-*`` flags, ``--passN-mode``
    (default ``--mode``) and ``--passN-sensitivity`` (pass 1: default
    ``--sensitivity``; pass 2: ``aggressive``), then ``--passN-overrides``,
    the JSON ``--passN-params`` (and ``-hf-``/``-qwen-params`` for those
    modes) and last the shared ``--overrides``."""
    from whisperjav_tpu_torch.config.presets import (
        apply_dot_overrides, resolve_pipeline_config,
    )
    cfgs = []
    for n, sens in ((1, args.pass1_sensitivity or args.sensitivity),
                    (2, args.pass2_sensitivity)):
        mode_n = getattr(args, f"pass{n}_mode") or args.mode
        c = resolve_pipeline_config(mode=mode_n, sensitivity=sens,
                                    **_pass_overrides(args, n, overrides))
        if getattr(args, f"pass{n}_overrides"):
            c = apply_dot_overrides(c, _parse_kv_args(
                getattr(args, f"pass{n}_overrides"),
                f"--pass{n}-overrides", keep_dots=True))
        merged = _json_flag(getattr(args, f"pass{n}_params"),
                            f"--pass{n}-params")
        for mode, kind in (("transformers", "hf"), ("qwen", "qwen")):
            if mode_n == mode:
                merged.update(_json_flag(
                    getattr(args, f"pass{n}_{kind}_params"),
                    f"--pass{n}-{kind}-params"))
        if merged:
            c = apply_dot_overrides(c, merged)
        if dot:
            c = apply_dot_overrides(c, dot)
        cfgs.append(c)
    return cfgs


def _write_summary(stats_file: Optional[str], summary: Dict) -> None:
    if stats_file:
        Path(stats_file).write_text(
            json.dumps(summary, indent=2, default=str), encoding="utf-8")


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if "--daemon-stop" in raw:
        # management action: no inputs required, exits immediately
        mini = argparse.ArgumentParser(add_help=False)
        mini.add_argument("--daemon-port", type=int, default=8478)
        known, _ = mini.parse_known_args(raw)
        return _daemon_stop(known.daemon_port)
    if "--check" in raw or "--check-verbose" in raw:
        # management action: no inputs required (the JAX parser asks for
        # one), rc 0 when every hard requirement passes
        from whisperjav_tpu_torch.utils.preflight import (
            run_preflight_checks,
        )
        return 0 if run_preflight_checks(verbose=True) else 1
    args = parse_arguments(raw)
    if args.asr:
        args.mode = _ASR_TO_MODE[args.asr]
    if args.features:
        for feat in (f.strip() for f in args.features.split(",")):
            if feat in _FEATURE_TO_SCENE and not args.scene_backend:
                args.scene_backend = _FEATURE_TO_SCENE[feat]
            elif feat and feat not in _FEATURE_TO_SCENE:
                print(f"warning: unknown feature {feat!r} ignored",
                      file=sys.stderr)
    missing = _unported(args)
    if missing:
        print("whisperjav-torch: not ported yet: " + ", ".join(missing),
              file=sys.stderr)
        return 2
    if args.compute_type:
        # faster-whisper precision spelling -> the int8 weight path
        args.int8_weights = args.compute_type.startswith("int8")
    if args.debug:
        args.verbosity = "debug"
    if args.make_vtt and args.output_format is None:
        args.output_format = "both"
    output_format = args.output_format or "srt"

    from whisperjav_tpu_torch.utils.logger import setup_logger
    logger = setup_logger(args.verbosity,
                          Path(args.log_file) if args.log_file else None)
    if args.crash_trace:
        import faulthandler
        faulthandler.enable()
    if args.condition_on_previous_text == "true":
        logger.warning("--condition-on-previous-text true is not supported: "
                       "all windows decode as one independent batch; "
                       "continuing without it")

    from whisperjav_tpu_torch.config.presets import (
        apply_dot_overrides, resolve_pipeline_config,
    )
    task = args.task or (
        "translate" if args.subs_language == "english-direct"
        else "transcribe")
    vad_kwargs = _parse_kv_args(args.vad_arg, "--vad-arg") or None
    if args.speech_pad_ms is not None:
        pad_s = args.speech_pad_ms / 1000.0
        vad_kwargs = {**(vad_kwargs or {}),
                      "pad_start_s": pad_s, "pad_end_s": pad_s}
    scene_kwargs = _parse_kv_args(args.scene_arg, "--scene-arg") or None
    enhancer_kwargs = ({"weights": args.enhancer_weights}
                       if args.enhancer_weights else None)
    extra_enh = _parse_kv_args(args.enhancer_arg, "--enhancer-arg")
    if extra_enh:
        enhancer_kwargs = {**(enhancer_kwargs or {}), **extra_enh}
    overrides = dict(
        language=args.language, task=task, model=args.model,
        batch_size=args.batch_size,
        vad_backend="none" if args.no_vad else args.vad_backend,
        scene_backend=args.scene_backend,
        vad_kwargs=vad_kwargs, scene_kwargs=scene_kwargs,
        enhancer_backend=args.enhancer, enhancer_kwargs=enhancer_kwargs,
        beam_size=args.beam_size,
        logprob_threshold=args.logprob_threshold,
        no_speech_threshold=args.no_speech_threshold,
        repetition_penalty=args.repetition_penalty,
        vad_threshold=args.vad_threshold,
        max_group_duration_s=args.max_group_duration,
        initial_prompt=args.prompt,
        no_timestamps=args.no_timestamps,
        pack_windows=not args.no_pack,
        word_timestamps=args.word_timestamps,
        int8_weights=args.int8_weights,
        vocab_slice=args.vocab_slice,
        enhance_for_vad=args.enhance_for_vad,
        keep_intermediates=args.keep_temp,
        output_format=output_format)
    checkpoint = args.checkpoint
    if args.mode == "transformers":
        # the --hf-* group maps onto the chunked long-form path
        if args.hf_model_id:
            checkpoint = checkpoint or args.hf_model_id
        for dest, key in (("hf_batch_size", "batch_size"),
                          ("hf_chunk_length", "chunk_s"),
                          ("hf_stride", "chunk_overlap_s"),
                          ("hf_beam_size", "beam_size")):
            if getattr(args, dest) is not None:
                overrides[key] = getattr(args, dest)
        if args.hf_temperature is not None:
            overrides["temperatures"] = (args.hf_temperature,)
        if args.hf_language:
            overrides["language"] = args.hf_language
        if args.hf_scene:
            overrides["scene_backend"] = args.hf_scene
        if args.hf_timestamps is not None:
            overrides["no_timestamps"] = args.hf_timestamps == "false"
    sensitivity = args.sensitivity
    if args.mode == "qwen":
        sensitivity = _qwen_overrides(args, overrides) or sensitivity
    cfg = resolve_pipeline_config(mode=args.mode, sensitivity=sensitivity,
                                  **overrides)
    dot = _parse_kv_args(args.overrides, "--overrides", keep_dots=True)
    if dot:
        cfg = apply_dot_overrides(cfg, dot)

    if args.dump_params:
        from dataclasses import asdict
        print(json.dumps({
            "mode": asdict(cfg.mode), "sensitivity": asdict(cfg.sensitivity),
            "language": cfg.language, "task": cfg.task, "model": cfg.model,
            "batch_size": cfg.batch_size, "output_format": cfg.output_format,
            "int8_weights": cfg.int8_weights,
            "word_timestamps": cfg.word_timestamps,
            "vocab_slice": cfg.vocab_slice,
            "enhancer_backend": cfg.enhancer_backend,
            "enhancer_kwargs": cfg.enhancer_kwargs,
            "enhance_for_vad": cfg.enhance_for_vad,
            "chunk_s": cfg.chunk_s, "chunk_overlap_s": cfg.chunk_overlap_s,
            "device": args.device or "cuda",
        }, indent=2))
        return 0

    from whisperjav_tpu_torch.modules.media_discovery import (
        discover, resolve_output_dir,
    )
    media = discover(args.inputs, recursive=args.recursive)
    if not media:
        logger.error("no media files found in inputs: %s", args.inputs)
        return 1
    if args.multihost:
        from whisperjav_tpu_torch.parallel.multihost import (
            initialize_distributed, shard_files,
        )
        try:
            proc, nprocs = initialize_distributed(
                args.coordinator, args.num_hosts, args.host_id)
        except (RuntimeError, ValueError) as e:
            logger.error("%s", e)
            return 1
        media = shard_files(media, proc, nprocs)
        if not media:
            logger.info("multihost: no files assigned to this process")
            return 0
    out_lang = cfg.language if task == "transcribe" else "en"
    if args.skip_existing:
        remaining = []
        for m in media:
            stem = f"{m.basename}.{out_lang}.whisperjav"
            out_dir = resolve_output_dir(args.output_dir, m)
            if (out_dir / f"{stem}.srt").exists() \
                    or (out_dir / f"{stem}.vtt").exists():
                logger.info("skip existing: %s.srt", stem)
            else:
                remaining.append(m)
        media = remaining
        if not media:
            logger.info("nothing to do")
            return 0

    from whisperjav_tpu_torch.utils.tracer import create_tracer
    tracer = create_tracer(Path(args.trace_params) if args.trace_params
                           else None)
    tracer.event("config", {"mode": cfg.mode.name,
                            "sensitivity": cfg.sensitivity.name,
                            "model": cfg.model})
    try:
        return _process(args, cfg, media, overrides, dot, checkpoint,
                        output_format, out_lang,
                        tracer if args.trace_params else None)
    finally:
        tracer.close()


def _process(args, cfg, media, overrides: Dict, dot: Dict,
             checkpoint: Optional[str], output_format: str, out_lang: str,
             tracer) -> int:
    """Transcribe ``media`` by the route the flags pick (resident engine,
    ensemble, async, or the file loop) and finalise every SRT written;
    the exit code."""
    from whisperjav_tpu_torch.modules.media_discovery import (
        resolve_output_dir,
    )
    from whisperjav_tpu_torch.utils.logger import logger
    postprocessor = None
    if not args.no_sanitize:
        from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor
        postprocessor = SRTPostProcessor(
            regroup_preset=args.postprocess_preset)

    device = args.device or "cuda"

    def finalize(srt_path: Path) -> None:
        """Signatures, then translation, then VTT conversion."""
        if args.credit or not args.no_signature:
            from whisperjav_tpu_torch.modules.srt import add_signatures
            add_signatures(srt_path, producer_credit=args.credit,
                           add_technical_sig=not args.no_signature,
                           mode=cfg.mode.name,
                           sensitivity=cfg.sensitivity.name)
        if args.translate:
            _translate_output(args, srt_path, device)
        if output_format in ("vtt", "both"):
            from whisperjav_tpu_torch.modules.srt import srt_to_vtt
            srt_to_vtt(srt_path)
            if output_format == "vtt":
                srt_path.unlink()

    daemon_eligible = args.daemon and not args.ensemble
    if args.daemon and args.ensemble:
        logger.warning("--daemon does not cover ensemble mode (two engine "
                       "configs per file); continuing in-process")
    if daemon_eligible and cfg.mode.name == "qwen":
        # the resident qwen engine runs the DEFAULT decoupled stack
        # (pipelines/qwen_factory.py); stack-level knobs can't reach it
        deep = _qwen_deep_flags(args)
        if deep:
            logger.warning(
                "--daemon: qwen stack knobs (%s) can't be routed to a "
                "resident engine; continuing in-process", ", ".join(deep))
            daemon_eligible = False
    if daemon_eligible:
        from whisperjav_tpu_torch.pipelines.daemon_client import (
            daemon_reproducible,
        )
        if not daemon_reproducible(cfg):
            logger.warning(
                "--daemon: this invocation carries config overrides a "
                "daemon can't receive (scene/VAD/enhancer/decode knobs); "
                "continuing in-process")
            daemon_eligible = False
    if daemon_eligible:
        # the daemon owns scenes/VAD/decode/sanitize under ITS config
        # (fingerprint-matched in find_daemon); this process discovers
        # media, writes outputs, and runs signatures/translation/VTT
        from whisperjav_tpu_torch.pipelines.daemon_client import get_daemon
        client = get_daemon(cfg, port=args.daemon_port,
                            checkpoint=checkpoint, device=device,
                            replace=args.daemon_replace)
        if client is not None:
            return _daemon_batch(client, media, cfg, args.output_dir,
                                 out_lang, finalize, args.stats_file,
                                 args.daemon_port, tracer)
        logger.warning("--daemon requested but no resident engine is "
                       "available; continuing in-process")

    if args.ensemble:
        from whisperjav_tpu_torch.ensemble.orchestrator import (
            EnsembleOrchestrator,
        )
        cfg1, cfg2 = _ensemble_configs(args, overrides, dot)
        summary = EnsembleOrchestrator(
            cfg1, cfg2, merge_strategy=args.merge_strategy,
            checkpoint=checkpoint, postprocessor=postprocessor,
            serial_mode=args.ensemble_serial, device=device,
        ).process_batch(media, args.output_dir)
        for r in summary.get("results", []):
            if r.get("output"):
                finalize(Path(r["output"]))
        _write_summary(args.stats_file, summary)
        logger.info("ensemble done: %d ok, %d degraded, %d failed",
                    summary["ok"], summary["degraded"], summary["failed"])
        return 0 if summary["failed"] == 0 else 2

    if cfg.mode.name == "qwen":
        pipeline = _qwen_pipeline(args, cfg, checkpoint, device)
    else:
        from whisperjav_tpu_torch.parallel.mesh import DevicesConflict
        from whisperjav_tpu_torch.pipelines.factory import build_pipeline
        try:
            pipeline = build_pipeline(cfg, checkpoint=checkpoint,
                                      postprocessor=postprocessor,
                                      device=device, tracer=tracer,
                                      devices=args.devices)
        except DevicesConflict as e:
            print(f"whisperjav-torch: {e}", file=sys.stderr)
            return 2

    if args.async_processing and cfg.mode.name != "qwen":
        # as in the JAX CLI, qwen mode takes the file loop below
        from whisperjav_tpu_torch.utils.async_processor import (
            AsyncPipelineManager,
        )
        t_start = time.time()
        outcomes = AsyncPipelineManager(
            pipeline, max_prefetch=max(args.max_workers, 1),
        ).process_files(media, args.output_dir)
        failures = sum(1 for o in outcomes if not o.ok)
        # every written SRT is finalised, as in the file loop (the JAX
        # CLI reads a srt_path attribute the written Path does not have)
        for o in outcomes:
            if o.ok:
                finalize(Path(o.result))
        summary = {
            "files": len(media), "failures": failures,
            "wall_s": round(time.time() - t_start, 2),
            "results": [{"file": str(o.media.path), "ok": o.ok,
                         "output": str(o.result) if o.ok else None,
                         "error": o.error} for o in outcomes]}
        _write_summary(args.stats_file, summary)
        logger.info("done (async): %d file(s), %d failure(s), %.1fs",
                    len(media), failures, summary["wall_s"])
        return 0 if failures == 0 else 2

    from whisperjav_tpu_torch.utils.progress import ProgressManager
    progress = ProgressManager(
        enabled=False if (args.no_progress or args.verbosity == "quiet")
        else None)
    progress.task("files", len(media))
    results, failures = [], 0
    t_start = time.time()
    for m in media:
        try:
            with progress.suppress_external():
                result = pipeline.process(
                    m, resolve_output_dir(args.output_dir, m))
            finalize(Path(result.srt_path))
            results.append(result.metadata)
        except Exception as e:  # keep the batch going
            logger.error("failed on %s: %s", m.path.name, e, exc_info=True)
            failures += 1
        progress.advance("files")
    progress.finish("files")
    summary = {"files": len(media), "failures": failures,
               "wall_s": round(time.time() - t_start, 2),
               "results": results}
    _write_summary(args.stats_file, summary)
    logger.info("done: %d file(s), %d failure(s), %.1fs", len(media),
                failures, summary["wall_s"])
    return 0 if failures == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
