from perceiver_io_tpu_torch.models.text.classifier import TextClassifier, TextClassifierConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel, MaskedLanguageModelConfig, TextDecoderConfig

__all__ = [
    "CausalLanguageModel",
    "CausalLanguageModelConfig",
    "MaskedLanguageModel",
    "MaskedLanguageModelConfig",
    "TextClassifier",
    "TextClassifierConfig",
    "TextDecoderConfig",
    "TextEncoderConfig",
]
