from whisperjav_tpu_torch.config.presets import (
    ModePreset, SensitivityPreset, resolve_pipeline_config,
)
