"""Text classifier: the text encoder and a classification decoder
(counterpart of ``perceiver_io_tpu/models/text/classifier.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_tpu_torch.core.adapter import ClassificationOutputAdapter, TrainableQueryProvider
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.core.modules import PerceiverDecoder, PerceiverIO
from perceiver_io_tpu_torch.device import DeviceLike
from perceiver_io_tpu_torch.models.base import building_on, finish_model
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig, make_text_encoder, make_text_input_adapter

TextClassifierConfig = PerceiverIOConfig[TextEncoderConfig, ClassificationDecoderConfig]


class TextClassifier(PerceiverIO):
    """``forward(x, pad_mask=None, deterministic=True, generator=None)``
    gives (B, num_classes) logits for token ids ``x`` (B, N) (one output
    query; (B, Q, num_classes) for Q of them). ``device``, ``generator`` and
    ``dtype`` as for :class:`~perceiver_io_tpu_torch.models.text.mlm.MaskedLanguageModel`."""

    def __init__(self, config: TextClassifierConfig, *, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        dev, context = building_on(device)
        enc, dec = config.encoder, config.decoder
        with context:
            input_adapter = make_text_input_adapter(enc, dtype)
            encoder = make_text_encoder(enc, input_adapter, config.num_latents, config.num_latent_channels,
                                        config.activation_checkpointing, config.activation_offloading, dtype)
            decoder = PerceiverDecoder(
                ClassificationOutputAdapter(dec.num_classes, dec.num_output_query_channels, dtype),
                TrainableQueryProvider(dec.num_output_queries, dec.num_output_query_channels, dtype),
                config.num_latent_channels, activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **dec.base_kwargs(),
            )
            super().__init__(encoder, decoder)
        self.config = config
        self.dtype = dtype
        finish_model(self, dev, [(encoder, enc.init_scale), (decoder, dec.init_scale)], generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider._query.device
