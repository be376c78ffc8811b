from perceiver_io_tpu_torch.models.vision.image_classifier import (
    ImageClassifier,
    ImageClassifierConfig,
    ImageEncoderConfig,
    ImageInputAdapter,
)
from perceiver_io_tpu_torch.models.vision.optical_flow import (
    OpticalFlow,
    OpticalFlowConfig,
    OpticalFlowDecoderConfig,
    OpticalFlowEncoderConfig,
)

__all__ = [
    "ImageClassifier",
    "ImageClassifierConfig",
    "ImageEncoderConfig",
    "ImageInputAdapter",
    "OpticalFlow",
    "OpticalFlowConfig",
    "OpticalFlowDecoderConfig",
    "OpticalFlowEncoderConfig",
]
