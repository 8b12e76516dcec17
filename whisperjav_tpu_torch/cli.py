"""``whisperjav-torch``: the ``whisperjav`` command line on the PyTorch port.

Flags and defaults are the JAX package's own (``whisperjav_tpu.cli``
parses them; it imports no jax), so a flagless run is balanced mode at
balanced sensitivity: turbo, energy scenes, silero-calibrated VAD,
batch 32, beam 2 with the temperature ladder. ``--device`` picks the
device (default ``cuda``; a CUDA device that is not there is an error).

``--int8-weights`` runs the decoder on int8 weights through the fused
decode blocks; the faster-whisper spelling ``--compute-type int8*``
turns it on and ``float*`` off, as in the JAX CLI.

What the port does not cover yet makes it exit with "not ported yet"
before any work: modes other than faster/fast/balanced, and the flags
listed in ``_UNPORTED``.

    whisperjav-torch clip.wav --output-dir out/
    whisperjav-torch clip.wav --model large-v2 --int8-weights
    python -m whisperjav_tpu_torch.cli clip.wav --output-dir out/
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from whisperjav_tpu.cli import (
    _ASR_TO_MODE, _FEATURE_TO_SCENE, _parse_kv_args, parse_arguments,
)

PORTED_MODES = ("faster", "fast", "balanced")
_SCENE_BACKENDS = ("energy", "auditok", "default", "none", "null")
_VAD_BACKENDS = ("silero", "silero-jax", "energy", "default", "none",
                 "null")
# argparse dest -> the flag a user typed, for flags outside the port
_UNPORTED = {
    "word_timestamps": "--word-timestamps",
    "ensemble": "--ensemble", "daemon": "--daemon",
    "daemon_replace": "--daemon-replace", "multihost": "--multihost",
    "async_processing": "--async-processing", "translate": "--translate",
    "vocab_slice": "--vocab-slice", "enhancer": "--enhancer",
    "enhancer_weights": "--enhancer-weights",
    "enhance_for_vad": "--enhance-for-vad", "enhancer_arg": "--enhancer-arg",
    "check": "--check", "check_verbose": "--check-verbose",
    "trace_params": "--trace-params",
}


def _unported(args) -> List[str]:
    """Every requested flag, mode or backend the port does not run."""
    out = [flag for dest, flag in _UNPORTED.items() if getattr(args, dest)]
    if args.mode not in PORTED_MODES:
        out.append(f"--mode {args.mode}")
    if args.devices is not None and args.devices > 1:
        out.append(f"--devices {args.devices}")
    if args.model and args.model.startswith("qwen"):
        out.append(f"--model {args.model}")
    if args.scene_backend and args.scene_backend.lower() not in \
            _SCENE_BACKENDS:
        out.append(f"--scene-backend {args.scene_backend}")
    if args.vad_backend and args.vad_backend.lower().replace("_", "-") \
            not in _VAD_BACKENDS:
        out.append(f"--vad-backend {args.vad_backend}")
    if "weights" in _parse_kv_args(args.vad_arg, "--vad-arg"):
        out.append("--vad-arg weights=... (the Silero network)")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if "--daemon-stop" in raw:
        print("whisperjav-torch: not ported yet: --daemon-stop",
              file=sys.stderr)
        return 2
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

    from whisperjav_tpu.utils.logger import setup_logger
    logger = setup_logger(args.verbosity,
                          Path(args.log_file) if args.log_file else None)
    if args.crash_trace:
        import faulthandler
        faulthandler.enable()
    if args.condition_on_previous_text == "true":
        logger.warning("--condition-on-previous-text true is not supported: "
                       "all windows decode as one independent batch; "
                       "continuing without it")

    from whisperjav_tpu.config.presets import (
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
    cfg = resolve_pipeline_config(
        mode=args.mode, sensitivity=args.sensitivity,
        language=args.language, task=task, model=args.model,
        batch_size=args.batch_size,
        vad_backend="none" if args.no_vad else args.vad_backend,
        scene_backend=args.scene_backend,
        vad_kwargs=vad_kwargs, scene_kwargs=scene_kwargs,
        beam_size=args.beam_size,
        logprob_threshold=args.logprob_threshold,
        no_speech_threshold=args.no_speech_threshold,
        repetition_penalty=args.repetition_penalty,
        vad_threshold=args.vad_threshold,
        max_group_duration_s=args.max_group_duration,
        initial_prompt=args.prompt,
        no_timestamps=args.no_timestamps,
        pack_windows=not args.no_pack,
        int8_weights=args.int8_weights,
        keep_intermediates=args.keep_temp,
        output_format=output_format)
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
            "device": args.device or "cuda",
        }, indent=2))
        return 0

    from whisperjav_tpu.modules.media_discovery import (
        discover, resolve_output_dir,
    )
    media = discover(args.inputs, recursive=args.recursive)
    if not media:
        logger.error("no media files found in inputs: %s", args.inputs)
        return 1
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

    postprocessor = None
    if not args.no_sanitize:
        from whisperjav_tpu.modules.sanitize import SRTPostProcessor
        postprocessor = SRTPostProcessor(
            regroup_preset=args.postprocess_preset)

    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    pipeline = build_pipeline(cfg, checkpoint=args.checkpoint,
                              postprocessor=postprocessor,
                              device=args.device or "cuda")

    def finalize(srt_path: Path) -> None:
        """Signatures, then VTT conversion."""
        if args.credit or not args.no_signature:
            from whisperjav_tpu.modules.srt import add_signatures
            add_signatures(srt_path, producer_credit=args.credit,
                           add_technical_sig=not args.no_signature,
                           mode=cfg.mode.name,
                           sensitivity=cfg.sensitivity.name)
        if output_format in ("vtt", "both"):
            from whisperjav_tpu.modules.srt import srt_to_vtt
            srt_to_vtt(srt_path)
            if output_format == "vtt":
                srt_path.unlink()

    results, failures = [], 0
    t_start = time.time()
    for m in media:
        try:
            result = pipeline.process(
                m, resolve_output_dir(args.output_dir, m))
            finalize(Path(result.srt_path))
            results.append(result.metadata)
        except Exception as e:  # keep the batch going
            logger.error("failed on %s: %s", m.path.name, e, exc_info=True)
            failures += 1
    summary = {"files": len(media), "failures": failures,
               "wall_s": round(time.time() - t_start, 2),
               "results": results}
    if args.stats_file:
        Path(args.stats_file).write_text(
            json.dumps(summary, indent=2, default=str), encoding="utf-8")
    logger.info("done: %d file(s), %d failure(s), %.1fs", len(media),
                failures, summary["wall_s"])
    return 0 if failures == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
