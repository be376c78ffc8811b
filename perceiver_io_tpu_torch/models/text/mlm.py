"""Masked language model: the text encoder, one learned output query per
position, and logits tied to the token embedding or from a head of their own
(counterpart of ``perceiver_io_tpu/models/text/mlm.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from perceiver_io_tpu_torch.core.adapter import TiedTokenOutputAdapter, TokenOutputAdapter, TrainableQueryProvider
from perceiver_io_tpu_torch.core.config import DecoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.core.modules import PerceiverDecoder, PerceiverIO
from perceiver_io_tpu_torch.device import DeviceLike
from perceiver_io_tpu_torch.models.base import building_on, finish_model
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig, make_text_encoder, make_text_input_adapter


@dataclass
class TextDecoderConfig(DecoderConfig):
    num_output_query_channels: Optional[int] = None
    vocab_size: int = 10003
    max_seq_len: int = 512


MaskedLanguageModelConfig = PerceiverIOConfig[TextEncoderConfig, TextDecoderConfig]


class MaskedLanguageModel(PerceiverIO):
    """``forward(x_masked, pad_mask=None, deterministic=True, generator=None)``
    gives (B, N, vocab) logits for token ids ``x_masked`` (B, N).

    When ``decoder.num_output_query_channels`` is None the output queries
    have the encoder's input width and the logits are tied to the token
    embedding (``x @ E^T + bias``, the ``deepmind/language-perceiver``
    layout); otherwise an independent linear head computes them. The decoder
    has ``decoder.max_seq_len`` queries, and the logits are its first N
    rows.

    :param device: ``"cuda"`` by default (raises without a card; pass
        ``device="cpu"``); ``"meta"`` builds the shapes alone.
    :param generator: CPU ``torch.Generator`` of the random initialization
        (``models.base.finish_model``).
    :param dtype: the compute dtype; the parameters are f32 either way.
    """

    def __init__(self, config: MaskedLanguageModelConfig, *, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        dev, context = building_on(device)
        enc, dec = config.encoder, config.decoder
        with context:
            input_adapter = make_text_input_adapter(enc, dtype)
            encoder = make_text_encoder(enc, input_adapter, config.num_latents, config.num_latent_channels,
                                        config.activation_checkpointing, config.activation_offloading, dtype)
            tied = dec.num_output_query_channels is None
            if tied:
                query = TrainableQueryProvider(dec.max_seq_len, enc.num_input_channels, dtype)
                output_adapter = TiedTokenOutputAdapter(dec.vocab_size)
            else:
                query = TrainableQueryProvider(dec.max_seq_len, dec.num_output_query_channels, dtype)
                output_adapter = TokenOutputAdapter(dec.vocab_size, dec.num_output_query_channels, dtype)
            decoder = PerceiverDecoder(
                output_adapter, query, config.num_latent_channels,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **dec.base_kwargs(),
            )
            super().__init__(encoder, decoder)
        self.config = config
        self.dtype = dtype
        self.tied = tied
        finish_model(self, dev, [(encoder, enc.init_scale), (decoder, dec.init_scale)], generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider._query.device

    def forward(self, x_masked: torch.Tensor, pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x_masked.shape[1]
        x_latent = self.encoder(x_masked, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        kwargs = {"attend": self.encoder.input_adapter.attend} if self.tied else {}
        logits = self.decoder(x_latent, deterministic=deterministic, generator=generator, **kwargs)
        return logits[:, :n]
