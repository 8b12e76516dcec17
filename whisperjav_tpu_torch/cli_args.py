"""The ``whisperjav`` argument parser, for the port's command line.

A copy of ``whisperjav_tpu/cli.py``'s ``parse_arguments`` and its
helpers, so that ``whisperjav-torch`` accepts every flag of the JAX CLI
(and refuses the ones it does not run with "not ported yet") without
importing the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional


def parse_arguments(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="whisperjav",
        description="TPU-native Japanese ASR → SRT subtitle pipeline",
    )
    p.add_argument("inputs", nargs="+",
                   help="media files, directories, or glob patterns")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="JSON file of flag defaults (flag names with "
                        "dashes or underscores); explicit CLI flags win "
                        "(reference: main.py:172)")
    p.add_argument("--asr", default=None,
                   choices=["faster_whisper", "openai_whisper", "stable_ts",
                            "kotoba_faster_whisper", "transformers",
                            "qwen3", "qwen"],
                   help="ASR component spelling (reference ensemble-mode "
                        "resolver, main.py:178) — maps onto --mode")
    p.add_argument("--features", default=None,
                   help="comma-separated feature names (reference: "
                        "main.py:182), e.g. auditok_scene_detection")
    p.add_argument("--pipeline-config", default=None, metavar="FILE",
                   help="YAML/JSON file of decoupled-pipeline defaults "
                        "(reference: main.py:653); CLI flags win")
    p.add_argument("--mode", "--pipeline", dest="mode", default="balanced",
                   choices=["faster", "fast", "balanced", "fidelity",
                            "transformers", "qwen", "anime"],
                   help="pipeline mode preset")
    p.add_argument("--sensitivity", default="balanced",
                   choices=["conservative", "balanced", "aggressive"],
                   help="decoding/VAD sensitivity preset")
    p.add_argument("--model", default=None,
                   help="whisper size override (tiny/base/small/medium/"
                        "large-v2/large-v3/turbo)")
    p.add_argument("--checkpoint", default=None,
                   help="local HF checkpoint directory with model weights")
    p.add_argument("--language", "--lang", dest="language", default="ja")
    p.add_argument("--subs-language", default="japanese",
                   choices=["japanese", "english-direct"],
                   help="english-direct uses Whisper's translate task")
    p.add_argument("--task", default=None,
                   choices=["transcribe", "translate"],
                   help="explicit task override (wins over --subs-language)")
    # "source" (the reference's default, main.py:286) saves each SRT
    # next to its own input file; anything else is a literal directory
    p.add_argument("--output-dir", default="source")
    p.add_argument("--temp-dir", default=None)
    p.add_argument("--keep-temp", action="store_true",
                   help="keep intermediate artifacts (raw pre-sanitize SRT)")
    p.add_argument("--output-format", default=None,
                   choices=["srt", "vtt", "both"],
                   help="vtt converts and removes the SRT; both keeps it")
    p.add_argument("--batch-size", type=int, default=None,
                   help="decode windows per device batch "
                        "(default: the mode's measured per-"
                        "chip optimum, 32 — ADR-002 B-sweep)")
    p.add_argument("--vad-backend", "--speech-segmenter", "--vad",
                   dest="vad_backend", default=None,
                   help="override VAD backend (energy/silero/whisperseg/"
                        "ten/whisper-vad/none)")
    p.add_argument("--no-vad", action="store_true",
                   help="disable VAD (full-group decode)")
    p.add_argument("--scene-backend", "--scene-detection-method",
                   dest="scene_backend", default=None,
                   help="override scene backend (energy/semantic/silero/none)")
    p.add_argument("--enhancer", "--speech-enhancer", dest="enhancer",
                   default=None,
                   help="speech enhancement backend "
                        "(none/dsp/zipenhancer/bs-roformer/clearvoice)")
    p.add_argument("--enhancer-weights", default=None,
                   help=".npz weights for the enhancement model")
    p.add_argument("--enhance-for-vad", action="store_true",
                   help="enhanced audio drives VAD only; ASR decodes the "
                        "original track")
    # fine-grained decode/VAD overrides (reference flag-surface parity)
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--no-timestamps", action="store_true",
                   help="decode without timestamp tokens")
    p.add_argument("--prompt", "--initial-prompt", dest="prompt",
                   default=None,
                   help="initial prompt text conditioning the decoder")
    p.add_argument("--condition-on-previous-text", default=None,
                   choices=["true", "false"],
                   help="carry decoded text across windows; the TPU engine "
                        "decodes windows as one independent batch, so only "
                        "'false' (the reference presets' JAV default) is "
                        "supported — 'true' warns and is ignored")
    p.add_argument("--logprob-threshold", type=float, default=None)
    p.add_argument("--no-speech-threshold", type=float, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--vad-threshold", type=float, default=None)
    p.add_argument("--speech-pad-ms", type=float, default=None,
                   help="context padding added around speech segments")
    p.add_argument("--vad-arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="per-backend VAD parameter (repeatable), e.g. "
                        "--vad-arg min_silence_duration_ms=200")
    p.add_argument("--scene-arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="per-backend scene-detection parameter (repeatable)")
    p.add_argument("--enhancer-arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="per-backend enhancement parameter (repeatable)")
    p.add_argument("--overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dot-notation config override (repeatable), e.g. "
                        "--overrides sensitivity.beam_size=3")
    p.add_argument("--max-group-duration", type=float, default=None,
                   help="max seconds of speech per decode window")
    p.add_argument("--no-pack", action="store_true",
                   help="disable packing multiple groups per decode window")
    p.add_argument("--int8-weights", action="store_true",
                   help="int8-quantize decoder weights (CTranslate2-style "
                        "int8 compute; slightly faster, near-lossless)")
    p.add_argument("--word-timestamps", action="store_true",
                   help="refine cue boundaries via cross-attention word "
                        "alignment (one extra forward pass per batch)")
    p.add_argument("--vocab-slice", default=None, metavar="ja|N",
                   help="decode against a language-plausible lm-head "
                        "slice ('ja' derives it from the checkpoint "
                        "tokenizer; an integer is a synthetic size). "
                        "Shrinks every (batch, vocab) logit rule ~3x; "
                        "restricts the emit set to the slice")
    p.add_argument("--no-sanitize", action="store_true",
                   help="skip subtitle sanitization")
    p.add_argument("--postprocess-preset", "--qwen-postprocess-preset",
                   dest="postprocess_preset", default="default",
                   choices=["default", "high_moan", "narrative"],
                   help="Japanese regrouping preset for the post chain")
    p.add_argument("--qwen-japanese-postprocess",
                   dest="qwen_japanese_postprocess", action="store_true",
                   help="deprecated parity flag: has no effect in qwen "
                        "mode (the assembly cleaner covers it) — matches "
                        "the reference's deprecation")
    p.add_argument("--no-qwen-japanese-postprocess",
                   dest="qwen_japanese_postprocess", action="store_false",
                   default=False)
    # signatures (reference: main.py:698-770 add_signatures_to_srt)
    p.add_argument("--credit", default=None,
                   help="producer credit cue inserted at the start of the SRT")
    p.add_argument("--no-signature", action="store_true",
                   help="skip the technical signature cue at the end")
    # transformers-mode (--hf-*) group (reference: main.py:478-517)
    hf = p.add_argument_group("transformers mode (--mode transformers)")
    hf.add_argument("--hf-model-id", default=None,
                    help="local checkpoint dir for the chunked HF-style "
                         "path (alias of --checkpoint in transformers mode)")
    hf.add_argument("--hf-batch-size", type=int, default=None)
    hf.add_argument("--hf-chunk-length", type=float, default=None,
                    help="chunk seconds for overlapped long-form decoding")
    hf.add_argument("--hf-stride", type=float, default=None,
                    help="overlap seconds between adjacent chunks")
    hf.add_argument("--hf-beam-size", type=int, default=None)
    hf.add_argument("--hf-temperature", type=float, default=None)
    hf.add_argument("--hf-language", default=None)
    hf.add_argument("--hf-scene", default=None,
                    help="scene backend for transformers mode")
    hf.add_argument("--hf-timestamps", default=None,
                    choices=["true", "false"],
                    help="emit timestamp tokens in transformers mode")
    # decoupled (qwen) stack knobs — reference main.py qwen group
    q = p.add_argument_group("qwen / decoupled mode (--mode qwen)")
    q.add_argument("--timestamp-mode", "--qwen-timestamp-mode",
                   dest="timestamp_mode", default=None,
                   choices=["aligner_interpolation", "aligner_vad_fallback",
                            "aligner_only", "vad_only"],
                   help="how null/collapsed timestamps are resolved")
    q.add_argument("--regroup-mode", "--qwen-regroup", dest="regroup_mode",
                   default=None,
                   choices=["standard", "sentence_only", "off"],
                   help="reconstruction regroup flavor")
    q.add_argument("--no-step-down", "--no-qwen-stepdown",
                   dest="no_step_down", action="store_true",
                   help="disable the collapsed-scene step-down retry")
    q.add_argument("--qwen-stepdown", dest="no_step_down",
                   action="store_false",
                   help="enable step-down (the default; parity spelling)")
    q.add_argument("--step-down-attempts", type=int, default=None,
                   help="step-down retry attempts (0 = disabled)")
    q.add_argument("--step-down-max-group", "--qwen-stepdown-fallback-group",
                   dest="step_down_max_group", type=float, default=None,
                   help="tighter max group seconds for step-down retries")
    q.add_argument("--qwen-stepdown-initial-group", type=float, default=None,
                   help="tier-1 group duration (seconds) before step-down")
    q.add_argument("--framer", "--qwen-framer", dest="framer", default=None,
                   choices=["vad-grouped", "full-scene", "srt-source"],
                   help="temporal framer for the decoupled stack")
    q.add_argument("--framer-srt-path", "--qwen-framer-srt-path",
                   dest="framer_srt_path", default=None,
                   help="existing SRT whose cue times frame the audio "
                        "(with --framer srt-source)")
    q.add_argument("--qwen-model-id", default=None,
                   help="qwen model size key (e.g. qwen3-asr-1.7b)")
    q.add_argument("--qwen-sensitivity", default=None,
                   choices=["conservative", "balanced", "aggressive"],
                   help="sensitivity override for qwen mode")
    q.add_argument("--qwen-batch-size", type=int, default=None)
    q.add_argument("--qwen-max-group-duration", type=float, default=None)
    q.add_argument("--qwen-scene", default=None,
                   help="scene backend for qwen mode (semantic default)")
    q.add_argument("--qwen-segmenter", default=None,
                   help="VAD backend for the vad-grouped framer")
    q.add_argument("--qwen-vad-threshold", type=float, default=None)
    q.add_argument("--qwen-repetition-penalty", type=float, default=None)
    q.add_argument("--qwen-enhancer", default=None,
                   help="enhancement backend for qwen mode")
    q.add_argument("--qwen-enhancer-model", default=None,
                   help=".npz weights for the qwen-mode enhancer")
    q.add_argument("--qwen-language", default=None,
                   help="language override for qwen mode (e.g. Japanese)")
    q.add_argument("--qwen-max-tokens", type=int, default=None,
                   help="hard cap on generated tokens per group")
    q.add_argument("--qwen-max-tokens-per-second", type=float, default=None,
                   help="dynamic token budget per audio second "
                        "(0 = disabled)")
    q.add_argument("--qwen-chunk-threshold", type=float, default=None,
                   help="silence gap (seconds) that closes a VAD group")
    q.add_argument("--qwen-vad-padding", type=int, default=None,
                   help="VAD speech padding in ms")
    q.add_argument("--qwen-input-mode", default="assembly",
                   choices=["assembly", "context_aware", "vad_slicing"],
                   help="'assembly' (default); the others are deprecated "
                        "reference aliases of it")
    q.add_argument("--qwen-safe-chunking", dest="qwen_safe_chunking",
                   action="store_true", default=True,
                   help="clamp scenes for the aligner's 180 s limit "
                        "(default on)")
    q.add_argument("--no-qwen-safe-chunking", dest="qwen_safe_chunking",
                   action="store_false",
                   help="allow arbitrarily long scenes")
    q.add_argument("--qwen-scene-min-duration", type=float, default=None,
                   help="minimum safe-chunked scene seconds (default 12)")
    q.add_argument("--qwen-scene-max-duration", type=float, default=None,
                   help="maximum safe-chunked scene seconds (default 48)")
    q.add_argument("--qwen-timestamps", default=None,
                   choices=["word", "none"],
                   help="'none' skips the forced aligner entirely")
    q.add_argument("--context", "--qwen-context", dest="context",
                   default=None,
                   help="context string biasing generation (speaker "
                        "names, domain terms)")
    q.add_argument("--context-file", "--qwen-context-file",
                   dest="context_file", default=None,
                   help="text file whose contents become --context")
    q.add_argument("--generator", "--qwen-generator", dest="generator",
                   default=None,
                   choices=["qwen3", "anime-whisper", "cohere"],
                   help="decoupled-stack generator backend (cohere = "
                        "experimental text-only LALM slot)")
    q.add_argument("--cleaner", default=None,
                   choices=["qwen3", "assembly", "passthrough"],
                   help="decoupled-stack text cleaner backend")
    q.add_argument("--qwen-assembly-cleaner", dest="qwen_assembly_cleaner",
                   action="store_true", default=True,
                   help="pre-alignment text cleaning (default on)")
    q.add_argument("--no-qwen-assembly-cleaner", dest="qwen_assembly_cleaner",
                   action="store_false")
    q.add_argument("--aligner", "--qwen-aligner", dest="aligner",
                   default=None,
                   help="decoupled-stack aligner backend (qwen3/none)")
    q.add_argument("--framer-config", default=None, metavar="JSON",
                   help="JSON kwargs for the framer backend")
    q.add_argument("--generator-config", default=None, metavar="JSON",
                   help="JSON kwargs for the generator backend")
    q.add_argument("--cleaner-config", default=None, metavar="JSON",
                   help="JSON kwargs for the cleaner backend")
    q.add_argument("--aligner-config", default=None, metavar="JSON",
                   help="JSON kwargs for the aligner backend")
    # ensemble
    e = p.add_argument_group("two-pass ensemble")
    e.add_argument("--ensemble", action="store_true",
                   help="two-pass ensemble mode")
    e.add_argument("--pass1-mode", "--pass1-pipeline", dest="pass1_mode",
                   default=None,
                   help="ensemble pass-1 mode (default: --mode)")
    e.add_argument("--pass1-sensitivity", default=None)
    e.add_argument("--pass1-model", default=None)
    e.add_argument("--pass1-vad-threshold", type=float, default=None)
    e.add_argument("--pass1-speech-segmenter", default=None)
    e.add_argument("--pass1-scene-detector", default=None)
    e.add_argument("--pass1-speech-enhancer", default=None)
    e.add_argument("--pass1-speech-pad-ms", type=float, default=None)
    e.add_argument("--pass1-enhance-for-vad", action="store_true")
    e.add_argument("--pass1-overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dot-notation overrides for pass 1 only")
    e.add_argument("--pass1-params", default=None, metavar="JSON",
                   help="JSON dict of config fields for pass 1 (flat or "
                        "dot-notation keys)")
    e.add_argument("--pass1-hf-params", default=None, metavar="JSON",
                   help="JSON hf params for pass 1 when its pipeline is "
                        "transformers")
    e.add_argument("--pass1-qwen-params", default=None, metavar="JSON",
                   help="JSON qwen params for pass 1 when its pipeline "
                        "is qwen")
    e.add_argument("--pass2-mode", "--pass2-pipeline", dest="pass2_mode",
                   default=None,
                   help="ensemble pass-2 mode (default: --mode)")
    e.add_argument("--pass2-sensitivity", default="aggressive")
    e.add_argument("--pass2-model", default=None)
    e.add_argument("--pass2-vad-threshold", type=float, default=None)
    e.add_argument("--pass2-speech-segmenter", default=None)
    e.add_argument("--pass2-scene-detector", default=None)
    e.add_argument("--pass2-speech-enhancer", default=None)
    e.add_argument("--pass2-speech-pad-ms", type=float, default=None)
    e.add_argument("--pass2-enhance-for-vad", action="store_true")
    e.add_argument("--pass2-overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dot-notation overrides for pass 2 only")
    e.add_argument("--pass2-params", default=None, metavar="JSON",
                   help="JSON dict of config fields for pass 2")
    e.add_argument("--pass2-hf-params", default=None, metavar="JSON")
    e.add_argument("--pass2-qwen-params", default=None, metavar="JSON")
    e.add_argument("--merge-strategy", default="smart_merge",
                   choices=["pass1_primary", "pass2_primary",
                            "pass1_overlap", "pass2_overlap",
                            "smart_merge", "full_merge", "longest"])
    e.add_argument("--ensemble-serial", action="store_true",
                   help="process files one at a time through both passes")
    p.add_argument("--translate", "--translate-provider", dest="translate",
                   default=None, metavar="PROVIDER",
                   help="translate output SRTs after transcription "
                        "(identity/deepseek/gpt/claude/gemini/ollama/…)")
    p.add_argument("--translate-model", default=None)
    p.add_argument("--translate-target", default="English")
    p.add_argument("--translate-tone", default="standard",
                   choices=["standard", "pornify"],
                   help="translation instruction-set flavor")
    p.add_argument("--translate-title", default=None,
                   help="movie title for translation context")
    p.add_argument("--translate-plot", default=None,
                   help="plot summary for translation context")
    p.add_argument("--translate-actress", default=None,
                   help="performer name(s) for pronoun/name handling")
    p.add_argument("--translate-endpoint", "--ollama-url",
                   dest="translate_endpoint", default=None,
                   help="custom API/Ollama base URL for translation")
    p.add_argument("--translate-api-key", default=None,
                   help="API key for the translation provider (exported "
                        "to the provider's key env var for this run)")
    p.add_argument("--translate-quiet", action="store_true",
                   help="hide translation progress messages")
    p.add_argument("--ollama-max-tokens", type=int, default=None,
                   help="accepted for reference compatibility; the TPU "
                        "build derives output budgets from the model's "
                        "context window (translate/ollama_manager.py)")
    p.add_argument("--ollama-num-ctx", type=int, default=None,
                   help="override the Ollama context window used to "
                        "derive the translation batch size")
    p.add_argument("--stream", action="store_true",
                   help="accepted for reference compatibility; providers "
                        "here run batch requests")
    p.add_argument("--yes", "-y", action="store_true",
                   help="auto-confirm prompts (server starts); the TPU "
                        "CLI never blocks on confirmation anyway")
    p.add_argument("--devices", type=int, default=None,
                   help="number of accelerator chips to shard window "
                        "batches over (default: all visible; 1 = "
                        "single-chip)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host batch job: join the processes' "
                        "torch.distributed (gloo) rendezvous and take "
                        "this process's slice of the file list (see "
                        "parallel/multihost.py)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address, served by --host-id 0")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    p.add_argument("--daemon", action="store_true",
                   help="route decoding through a resident whisperjav-serve "
                        "engine (autostarted when none is running): repeat "
                        "invocations skip the per-process first-batch "
                        "compile/load wall — the fast path for one-file-at-"
                        "a-time workflows and the GUI")
    p.add_argument("--daemon-port", type=int, default=8478,
                   help="port of the resident engine (--daemon)")
    p.add_argument("--daemon-stop", action="store_true",
                   help="stop the resident engine on --daemon-port and "
                        "exit (frees the chip for a different-config "
                        "daemon — two residents can exceed one chip's HBM)")
    p.add_argument("--daemon-replace", action="store_true",
                   help="with --daemon: if a resident engine with a "
                        "different config occupies the port, shut it "
                        "down and start a matching one instead of "
                        "falling back in-process")
    p.add_argument("--async-processing", action="store_true",
                   help="overlap host preprocessing with device decode")
    p.add_argument("--max-workers", type=int, default=2,
                   help="prefetch depth for --async-processing")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip files whose output SRT already exists")
    p.add_argument("--make-vtt", action="store_true",
                   help="also write a WebVTT copy (alias of "
                        "--output-format both)")
    p.add_argument("--stats-file", default=None,
                   help="write batch statistics JSON here")
    p.add_argument("--trace-params", default=None,
                   help="stream parameter-trace JSONL to this path")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--verbosity", "--log-level", dest="verbosity",
                   default="info",
                   choices=["quiet", "normal", "info", "verbose", "debug"])
    p.add_argument("--debug", action="store_true",
                   help="shortcut for --verbosity debug")
    p.add_argument("--no-progress", action="store_true",
                   help="accepted for reference-CLI compatibility; the TPU "
                        "CLI logs progress lines rather than drawing bars")
    p.add_argument("--log-file", default=None)
    p.add_argument("--check", action="store_true",
                   help="run environment preflight checks and exit")
    p.add_argument("--check-verbose", action="store_true",
                   help="alias of --check (reference main.py:267)")
    # ── CUDA/torch-era hardware flags (reference main.py hardware
    # group): accepted so reference command lines run unchanged; the
    # TPU build selects device/dtype itself. --compute-type maps onto
    # the int8-weight path (CTranslate2 int8 ≙ quant.py int8).
    p.add_argument("--device", default=None,
                   help="accepted for reference compatibility (cuda/cpu); "
                        "device selection here is JAX_PLATFORMS")
    p.add_argument("--compute-type", default=None,
                   choices=["int8", "int8_float16", "int8_bfloat16",
                            "float16", "bfloat16", "float32", "auto"],
                   help="CTranslate2-style precision: int8* enables "
                        "--int8-weights, float* disables it")
    p.add_argument("--accept-cpu-mode", action="store_true",
                   help="proceed without an accelerator (CPU fallback is "
                        "automatic here; flag accepted for compatibility)")
    p.add_argument("--crash-trace", action="store_true",
                   help="enable faulthandler crash tracebacks "
                        "(reference: utils/crash_tracer.py role)")
    p.add_argument("--xxl-exe", default=None,
                   help="accepted for reference compatibility; BYOP XXL "
                        "external executables are n/a on TPU (PARITY #59)")
    for _flag in ("--hf-attn", "--hf-device", "--hf-dtype", "--qwen-attn",
                  "--qwen-device", "--qwen-dtype",
                  "--translate-gpu-layers"):
        p.add_argument(_flag, default=None,
                       help="accepted for reference compatibility; "
                            "torch/CUDA-specific, no TPU effect")
    p.add_argument("--dump-params", action="store_true",
                   help="print the resolved runtime config and exit")
    p.add_argument("--version", action="version",
                   version=_version_string())
    _apply_config_file_defaults(p, argv)
    return p.parse_args(argv)


def _apply_config_file_defaults(p: argparse.ArgumentParser,
                                argv: Optional[List[str]]) -> None:
    """Pre-scan for --config and install the JSON file's values as parser
    defaults, so explicit CLI flags always win (reference: main.py:172 —
    JSON configuration file)."""
    av = list(sys.argv[1:] if argv is None else argv)
    paths = []
    for flag in ("--pipeline-config", "--config"):   # --config wins
        for i, a in enumerate(av):
            if a == flag and i + 1 < len(av):
                paths.append((flag, av[i + 1]))
            elif a.startswith(flag + "="):
                paths.append((flag, a.split("=", 1)[1]))
    if not paths:
        return
    known = {a.dest for a in p._actions}
    defaults = {}
    for flag, path in paths:
        text = None
        try:
            text = Path(path).read_text(encoding="utf-8")
            loaded = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
                loaded = yaml.safe_load(text)
            except Exception as e:  # noqa: BLE001
                raise SystemExit(f"{flag} {path}: {e}")
        except OSError as e:
            raise SystemExit(f"{flag} {path}: {e}")
        if not isinstance(loaded, dict):
            raise SystemExit(f"{flag} {path}: expected a mapping")
        for key, value in loaded.items():
            dest = key.replace("-", "_").lstrip("_")
            if dest not in known:
                raise SystemExit(f"{flag} {path}: unknown option {key!r}")
            defaults[dest] = value
    p.set_defaults(**defaults)


def _version_string() -> str:
    from whisperjav_tpu_torch.version import __version__
    return f"whisperjav-tpu {__version__}"


def _coerce(value: str) -> object:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value


def _parse_kv_args(pairs: List[str], flag: str,
                   keep_dots: bool = False) -> dict:
    """KEY=VALUE list → dict with int/float/bool coercion (the role of the
    reference factory's per-backend param schemas + type-coercion gate,
    speech_segmentation/factory.py:90-160)."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"{flag} expects KEY=VALUE, got {pair!r}")
        key, value = pair.split("=", 1)
        key = key.strip()
        if not keep_dots:
            key = key.replace("-", "_")
        out[key] = _coerce(value)
    return out


def _json_flag(value: Optional[str], flag: str) -> dict:
    """Parse a JSON-dict flag value (reference: main.py:2137 error path)."""
    if not value:
        return {}
    try:
        loaded = json.loads(value)
    except json.JSONDecodeError as e:
        raise SystemExit(f"invalid JSON in {flag}: {e}")
    if not isinstance(loaded, dict):
        raise SystemExit(f"{flag} expects a JSON object")
    return loaded


_ASR_TO_MODE = {
    # reference ensemble-resolver component names → mode presets
    # (main.py:178, pipelines registry)
    "faster_whisper": "faster",
    "kotoba_faster_whisper": "fast",
    "openai_whisper": "balanced",
    "stable_ts": "fidelity",
    "transformers": "transformers",
    "qwen3": "qwen",
    "qwen": "qwen",
}

_FEATURE_TO_SCENE = {
    "auditok_scene_detection": "energy",
    "silero_scene_detection": "silero",
    "semantic_scene_detection": "semantic",
}

