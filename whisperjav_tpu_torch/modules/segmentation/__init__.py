from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechSegment, create_segmenter, group_segments,
)
