from whisperjav_tpu_torch.modules.scene_detection.base import (
    Scene, SceneDetectionResult, SceneDetector, create_scene_detector,
)
