"""Mode and sensitivity presets — the single config system.

Replaces the reference's four coexisting config generations (SURVEY.md §5:
argparse + legacy v3 Pydantic + v4 YAML + asr_config.json) with one typed
preset registry. The *values* keep behavioral parity with the reference's
single-source-of-truth Pydantic presets (reference:
whisperjav/config/components/asr/faster_whisper.py:236-356 — beam 2-3,
logprob −0.84…−1.00, no_speech 0.54/0.65/0.72, repetition_penalty
1.8/1.5/1.3, temperature ladders; components/vad/silero.py:95-123 — VAD
threshold 0.41/0.28/0.18, max group 7/6/5 s), while the *mechanics* are a
flat dataclass resolve: mode → model/backends, sensitivity → thresholds,
CLI overrides last.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class SensitivityPreset:
    name: str
    # decoding
    beam_size: int
    temperatures: Tuple[float, ...]
    repetition_penalty: float
    # quality gates
    logprob_threshold: float
    no_speech_threshold: float
    # beam patience / sampled best-of (reference:
    # config/components/asr/faster_whisper.py:241-242,281-282,321-322)
    patience: float = 1.0
    best_of: int = 2
    # every reference sensitivity runs no_repeat_ngram_size=3
    # (faster_whisper.py:265,305,345 — "prevents repetition loops")
    no_repeat_ngram_size: int = 3
    compression_ratio_threshold: float = 2.4
    # VAD
    vad_threshold: float = 0.28
    max_group_duration_s: float = 6.0
    energy_vad_db: float = 40.0


SENSITIVITY_PRESETS: Dict[str, SensitivityPreset] = {
    "conservative": SensitivityPreset(
        name="conservative", beam_size=2, temperatures=(0.0,),
        repetition_penalty=1.8, logprob_threshold=-0.84,
        no_speech_threshold=0.54, vad_threshold=0.41,
        max_group_duration_s=7.0, energy_vad_db=42.0),
    "balanced": SensitivityPreset(
        name="balanced", beam_size=2, temperatures=(0.0, 0.2),
        repetition_penalty=1.5, patience=1.2,
        logprob_threshold=-0.92,
        no_speech_threshold=0.65, vad_threshold=0.28,
        max_group_duration_s=6.0, energy_vad_db=40.0),
    "aggressive": SensitivityPreset(
        name="aggressive", beam_size=3, temperatures=(0.0, 0.2),
        repetition_penalty=1.3, patience=1.3,
        logprob_threshold=-1.0,
        no_speech_threshold=0.72, vad_threshold=0.18,
        max_group_duration_s=5.0, energy_vad_db=37.0),
}


@dataclass(frozen=True)
class ModePreset:
    """What the reference calls a pipeline mode (--mode)."""
    name: str
    model: str                      # whisper size key
    scene_backend: str = "energy"
    vad_backend: str = "energy"
    with_timestamps: bool = True
    description: str = ""
    # flagless --batch-size: the measured per-chip optimum for the
    # mode's model (ADR-002 round-5 B-sweep: balanced/turbo peaks at
    # B=32, past ~64 effective decode rows the latency knee wins;
    # qwen-1.7b generate loop peaks B=32 at +18% over B=16)
    default_batch: int = 32


MODE_PRESETS: Dict[str, ModePreset] = {
    # reference: faster/fast → stable-ts over faster-whisper turbo
    "faster": ModePreset("faster", model="turbo", scene_backend="none",
                         vad_backend="none",
                         description="direct decode, no segmentation"),
    "fast": ModePreset("fast", model="turbo", scene_backend="energy",
                       vad_backend="none",
                       description="scene split + full-scene decode"),
    # reference: balanced → faster-whisper + external VAD
    "balanced": ModePreset("balanced", model="turbo", scene_backend="energy",
                           vad_backend="silero",
                           description="scene split + VAD grouping"),
    # reference: fidelity → whisper large-v2 + enhancement
    "fidelity": ModePreset("fidelity", model="large-v2",
                           scene_backend="energy", vad_backend="silero",
                           description="large-v2 + enhancement + VAD"),
    # reference: transformers → kotoba chunked pipeline
    "transformers": ModePreset("transformers", model="large-v2",
                               scene_backend="energy", vad_backend="none",
                               description="chunked long-form decode"),
    # reference: qwen → ChronosJAV decoupled assembly pipeline
    "qwen": ModePreset("qwen", model="qwen3-asr-1.7b",
                       scene_backend="semantic", vad_backend="whisperseg",
                       description="decoupled generate+align assembly"),
    # reference: anime → anime-whisper (Whisper fine-tune) + TEN-class VAD
    "anime": ModePreset("anime", model="large-v2", scene_backend="energy",
                        vad_backend="silero",
                        description="anime-whisper fine-tune decode"),
}


@dataclass
class PipelineConfig:
    """Fully resolved runtime configuration for one run."""
    mode: ModePreset
    sensitivity: SensitivityPreset
    language: str = "ja"
    task: str = "transcribe"
    model_override: Optional[str] = None
    batch_size: int = 8
    scene_kwargs: Dict = field(default_factory=dict)
    vad_kwargs: Dict = field(default_factory=dict)
    enhancer_backend: Optional[str] = None
    enhancer_kwargs: Dict = field(default_factory=dict)
    initial_prompt: Optional[str] = None
    no_timestamps: bool = False
    pack_windows: bool = True
    word_timestamps: bool = False
    int8_weights: bool = False
    # decode against a language-plausible lm-head slice
    # (models/whisper/vocab_subset.py): "ja" derives the subset from the
    # checkpoint tokenizer, an int string is a synthetic size. Opt-in —
    # it restricts the emit set (a behavior change, measured +11%
    # preset-decode RTF at a 16k subset, docs/ADR-002 round 4)
    vocab_slice: Optional[str] = None
    # dual-track: enhanced audio drives VAD only, ASR decodes the raw track
    # (reference: --enhance-for-vad, main.py:551,1056-1057)
    enhance_for_vad: bool = False
    # keep intermediate artifacts (raw pre-sanitize SRT) for debugging
    # (reference: --keep-temp keeps scene WAVs/raw_subs, main.py:292)
    keep_intermediates: bool = False
    # "srt" | "vtt" (convert + remove SRT) | "both"
    # (reference: apply_vtt_conversion, main.py:790-808)
    output_format: str = "srt"
    # overlapped-chunking geometry for transformers mode
    # (reference: --hf-chunk-length/--hf-stride, main.py:487-489)
    chunk_s: float = 30.0
    chunk_overlap_s: float = 5.0

    @property
    def model(self) -> str:
        return self.model_override or self.mode.model


def config_fingerprint(cfg: PipelineConfig) -> str:
    """Short stable hash of the FULL resolved config. The resident-engine
    router (pipelines/daemon_client.py) compares this instead of trusting
    the human-readable fields alone, so any knob that folds into the
    resolved config (dot-overrides, --vad-backend, sensitivity-field
    tweaks…) makes a mismatched daemon fall back to in-process decoding
    rather than silently decoding under different settings."""
    import hashlib
    from dataclasses import asdict
    d = asdict(cfg)
    # canonicalize: a daemon is started with the RESOLVED model name, so
    # {model_override: None, mode.model: turbo} and {model_override:
    # "turbo"} must hash identically
    d["model_override"] = cfg.model
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def resolve_pipeline_config(
    mode: str = "balanced",
    sensitivity: str = "balanced",
    language: str = "ja",
    task: str = "transcribe",
    model: Optional[str] = None,
    batch_size: Optional[int] = None,
    **overrides,
) -> PipelineConfig:
    """CLI-facing resolver. Precedence: explicit overrides > sensitivity
    preset > mode defaults (reference precedence contract:
    whisperjav/config/legacy.py:54-91 None-stripping)."""
    if mode not in MODE_PRESETS:
        raise ValueError(f"unknown mode {mode!r}; "
                         f"choose from {sorted(MODE_PRESETS)}")
    if sensitivity not in SENSITIVITY_PRESETS:
        raise ValueError(f"unknown sensitivity {sensitivity!r}; "
                         f"choose from {sorted(SENSITIVITY_PRESETS)}")
    sens = SENSITIVITY_PRESETS[sensitivity]
    clean = {k: v for k, v in overrides.items() if v is not None}
    sens_fields = {f for f in SensitivityPreset.__dataclass_fields__}
    sens = replace(sens, **{k: v for k, v in clean.items()
                            if k in sens_fields})
    mp = MODE_PRESETS[mode]
    cfg = PipelineConfig(
        mode=mp, sensitivity=sens, language=language,
        task=task, model_override=model,
        batch_size=batch_size if batch_size is not None
        else mp.default_batch,
    )
    if "vad_backend" in clean:
        cfg.mode = replace(cfg.mode, vad_backend=clean["vad_backend"])
    if "scene_backend" in clean:
        cfg.mode = replace(cfg.mode, scene_backend=clean["scene_backend"])
    if "scene_kwargs" in clean:
        cfg.scene_kwargs = clean["scene_kwargs"]
    if "vad_kwargs" in clean:
        cfg.vad_kwargs = clean["vad_kwargs"]
    if "enhancer_backend" in clean:
        cfg.enhancer_backend = clean["enhancer_backend"]
    if "enhancer_kwargs" in clean:
        cfg.enhancer_kwargs = clean["enhancer_kwargs"]
    if "initial_prompt" in clean:
        cfg.initial_prompt = clean["initial_prompt"]
    if clean.get("no_timestamps"):
        cfg.no_timestamps = True
    if "pack_windows" in clean:
        cfg.pack_windows = clean["pack_windows"]
    if clean.get("word_timestamps"):
        cfg.word_timestamps = True
    if clean.get("int8_weights"):
        cfg.int8_weights = True
    if "vocab_slice" in clean:
        cfg.vocab_slice = str(clean["vocab_slice"])
    if clean.get("enhance_for_vad"):
        cfg.enhance_for_vad = True
    if clean.get("keep_intermediates"):
        cfg.keep_intermediates = True
    if "output_format" in clean:
        cfg.output_format = clean["output_format"]
    if "chunk_s" in clean:
        cfg.chunk_s = float(clean["chunk_s"])
    if "chunk_overlap_s" in clean:
        cfg.chunk_overlap_s = float(clean["chunk_overlap_s"])
    # fidelity mode enhances by default (reference: fidelity pipeline runs
    # the enhancement phase; balanced can opt in via --enhancer)
    if mode == "fidelity" and cfg.enhancer_backend is None:
        cfg.enhancer_backend = "zipenhancer"
    return cfg


def apply_dot_overrides(cfg: PipelineConfig, overrides: Dict) -> PipelineConfig:
    """Apply dot-notation overrides onto a resolved config, e.g.
    ``{"sensitivity.beam_size": 3, "mode.vad_backend": "whisperseg",
    "batch_size": 16}`` (the role of the reference's ``--overrides`` /
    ensemble dot-notation resolver, config/legacy.py:362-438).

    Unknown keys raise ValueError so typos never silently no-op.
    """
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        if len(parts) == 1:
            key = parts[0]
            if key not in PipelineConfig.__dataclass_fields__:
                raise ValueError(f"unknown override {dotted!r}")
            setattr(cfg, key, value)
        elif len(parts) == 2 and parts[0] in ("sensitivity", "mode"):
            target = getattr(cfg, parts[0])
            if parts[1] not in type(target).__dataclass_fields__:
                raise ValueError(f"unknown override {dotted!r}")
            setattr(cfg, parts[0], replace(target, **{parts[1]: value}))
        else:
            raise ValueError(f"unknown override {dotted!r}")
    return cfg
