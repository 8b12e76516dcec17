from whisperjav_tpu_torch.modules.enhancement.base import (
    EnhancementResult, create_enhancer, enhance_scenes,
    get_extraction_sample_rate, is_passthrough_backend,
)
