"""Default qwen-mode pipeline builder (for a resident engine).

The port's copy of ``whisperjav_tpu/pipelines/qwen_factory.py``: the
DEFAULT stack the CLI's qwen knobs collapse to when unset — vad-grouped
framer under the mode's VAD backend, QwenGenerator, assembly cleaner,
qwen3 forced aligner, standard regroup, step-down enabled — driven only
by the resolved ``PipelineConfig``, on ``device``.

Reference whole-path: whisperjav/pipelines/qwen_pipeline.py:87-1056.
"""

from __future__ import annotations

from typing import Optional

from whisperjav_tpu_torch.pipelines.qwen import QwenPipeline


def build_qwen_pipeline(cfg, checkpoint: Optional[str] = None,
                        device="cuda") -> QwenPipeline:
    from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
        QwenGenerator, create_aligner, create_cleaner, create_framer,
    )
    from whisperjav_tpu_torch.modules.subtitle_pipeline.orchestrator import (
        DecoupledSubtitlePipeline,
    )
    from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
        RegroupMode, StepDownConfig,
    )

    model_size = (cfg.model if cfg.model.startswith("qwen")
                  else "qwen3-asr-1.7b")
    framer_kwargs = {"vad_backend": cfg.mode.vad_backend, "device": device}
    if cfg.vad_kwargs:
        framer_kwargs.update(cfg.vad_kwargs)
    decoupled = DecoupledSubtitlePipeline(
        framer=create_framer("vad-grouped", **framer_kwargs),
        generator=QwenGenerator(model_size=model_size,
                                batch_size=cfg.batch_size,
                                checkpoint=checkpoint, device=device),
        cleaner=create_cleaner("assembly"),
        aligner=create_aligner("qwen3", device=device),
        max_group_s=cfg.sensitivity.max_group_duration_s,
        step_down=StepDownConfig(enabled=True),
        regroup_mode=RegroupMode.STANDARD,
    )
    return QwenPipeline(
        decoupled,
        scene_backend=cfg.mode.scene_backend,
        scene_kwargs=cfg.scene_kwargs or None,
        enhancer_backend=cfg.enhancer_backend,
        language=cfg.language,
        device=device,
    )
