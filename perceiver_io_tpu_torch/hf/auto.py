"""Auto-model resolution: config dataclass -> model class -> loaded model
(counterpart of ``perceiver_io_tpu/hf/auto.py``).

The analog of the reference's HF auto-class registration (reference:
perceiver/model/*/huggingface.py ``AutoModelFor*.register``): a
``save_pretrained`` directory (``model.pt`` + ``config.json``) is enough to
rebuild the right model without naming its class. ``config.json`` may name
the JAX package's config classes: ``training.checkpoint.config_from_dict``
builds the port's class of the same path.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from perceiver_io_tpu_torch.core.config import (
    CausalSequenceModelConfig,
    ClassificationDecoderConfig,
    PerceiverIOConfig,
)
from perceiver_io_tpu_torch.device import DeviceLike


def auto_model_for_config(config: Any, *, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None,
                          generator: Optional[torch.Generator] = None):
    """The model for a config dataclass, built on ``device`` (seeded random
    weights from ``generator``; ``dtype`` the compute dtype, the model's
    default when None).

    Perceiver IO configs dispatch on their encoder/decoder dataclass types,
    causal sequence configs on the config class itself, in the JAX
    package's order (the symbolic audio config before the CLM's)."""
    from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
    from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
    from perceiver_io_tpu_torch.models.text.classifier import TextClassifier
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
    from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel
    from perceiver_io_tpu_torch.models.timeseries import TimeSeriesEncoderConfig, TimeSeriesPerceiver
    from perceiver_io_tpu_torch.models.vision.image_classifier import ImageClassifier, ImageEncoderConfig
    from perceiver_io_tpu_torch.models.vision.optical_flow import OpticalFlow, OpticalFlowEncoderConfig

    model_cls = None
    if isinstance(config, SymbolicAudioModelConfig):
        model_cls = SymbolicAudioModel
    elif isinstance(config, CausalLanguageModelConfig):
        model_cls = CausalLanguageModel
    elif isinstance(config, CausalSequenceModelConfig):
        model_cls = CausalSequenceModel
    elif isinstance(config, PerceiverIOConfig):
        enc, dec = config.encoder, config.decoder
        if isinstance(enc, OpticalFlowEncoderConfig):
            model_cls = OpticalFlow
        elif isinstance(enc, ImageEncoderConfig):
            model_cls = ImageClassifier
        elif isinstance(enc, TextEncoderConfig):
            model_cls = TextClassifier if isinstance(dec, ClassificationDecoderConfig) else MaskedLanguageModel
        elif isinstance(enc, TimeSeriesEncoderConfig):
            model_cls = TimeSeriesPerceiver
    if model_cls is None:
        raise ValueError(f"No model registered for config type {type(config).__name__}")
    kwargs = {} if dtype is None else {"dtype": dtype}
    return model_cls(config, device=device, generator=generator, **kwargs)


def from_pretrained(directory: str, *, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None):
    """The model of a ``save_pretrained`` directory (or of a training run's
    checkpoints, as ``training.load_pretrained`` reads them) on ``device``,
    its weights loaded. The JAX function returns ``(model, variables)``; a
    port model holds its weights, so this returns the model alone."""
    from perceiver_io_tpu_torch.training.checkpoint import load_pretrained

    weights, config = load_pretrained(directory)
    if config is None:
        raise ValueError(f"{directory} has no config.json — cannot auto-resolve the model")
    model = auto_model_for_config(config, device=device, dtype=dtype)
    model.load_state_dict(weights, strict=True)
    return model
