"""The shared text encoder (counterpart of
``perceiver_io_tpu/models/text/common.py``): the token input adapter with
learned absolute positions and the Perceiver IO encoder over it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from perceiver_io_tpu_torch.core.adapter import TokenInputAdapter
from perceiver_io_tpu_torch.core.config import EncoderConfig
from perceiver_io_tpu_torch.core.modules import PerceiverEncoder


@dataclass
class TextEncoderConfig(EncoderConfig):
    vocab_size: int = 10003
    max_seq_len: int = 256
    num_input_channels: int = 64
    params: Optional[str] = None  # checkpoint path / repo id for warm start


def make_text_input_adapter(config: TextEncoderConfig, dtype: torch.dtype = torch.float32) -> TokenInputAdapter:
    return TokenInputAdapter(config.vocab_size, config.max_seq_len, config.num_input_channels, dtype=dtype)


def make_text_encoder(config: TextEncoderConfig, input_adapter: TokenInputAdapter, num_latents: int,
                      num_latent_channels: int, activation_checkpointing: bool = False,
                      activation_offloading: bool = False, dtype: torch.dtype = torch.float32) -> PerceiverEncoder:
    """The generic text encoder: the token adapter + a Perceiver IO encoder.
    The adapter is passed in, not built here, so a task model can tie its
    output logits to it."""
    return PerceiverEncoder(input_adapter, num_latents, num_latent_channels,
                            activation_checkpointing=activation_checkpointing,
                            activation_offloading=activation_offloading, dtype=dtype, **config.base_kwargs())
