from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    AlignmentResult, FramingResult, HardeningConfig, SceneDiagnostics,
    StepDownConfig, TemporalFrame, TimestampMode, TranscriptionResult,
    WordTimestamp,
)
from whisperjav_tpu_torch.modules.subtitle_pipeline.orchestrator import (
    DecoupledSubtitlePipeline,
)
