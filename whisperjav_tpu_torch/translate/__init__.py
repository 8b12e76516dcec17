from whisperjav_tpu_torch.translate.service import (
    translate_srt, translate_with_config,
)
