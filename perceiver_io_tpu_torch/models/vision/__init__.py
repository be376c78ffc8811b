from perceiver_io_tpu_torch.models.vision.image_classifier import (
    ImageClassifier,
    ImageClassifierConfig,
    ImageEncoderConfig,
    ImageInputAdapter,
)

__all__ = ["ImageClassifier", "ImageClassifierConfig", "ImageEncoderConfig", "ImageInputAdapter"]
