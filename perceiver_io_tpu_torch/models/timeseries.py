"""Multivariate time-series forecasting Perceiver (counterpart of
``perceiver_io_tpu/models/timeseries.py``): a linear projection of the series
plus a bias-free projection of 1-D Fourier position encodings (added, not
appended), a learned query per output step and a linear head; seq-to-seq
forecasting under an MSE loss. Parameter names are the reference
application's (``encoder.input_adapter.pos_proj.weight``, ``decoder.*``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from perceiver_io_tpu_torch.core.adapter import TrainableQueryProvider
from perceiver_io_tpu_torch.core.config import DecoderConfig, EncoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.core.modules import PerceiverDecoder, PerceiverEncoder
from perceiver_io_tpu_torch.core.position import fourier_position_encodings
from perceiver_io_tpu_torch.device import DeviceLike
from perceiver_io_tpu_torch.models.base import building_on, finish_model


@dataclass
class TimeSeriesEncoderConfig(EncoderConfig):
    num_input_channels: int = 7  # data channels per time step
    in_len: int = 5000
    num_frequency_bands: int = 64


@dataclass
class TimeSeriesDecoderConfig(DecoderConfig):
    out_len: int = 5000
    num_output_channels: int = 7


TimeSeriesPerceiverConfig = PerceiverIOConfig[TimeSeriesEncoderConfig, TimeSeriesDecoderConfig]


class TimeSeriesInputAdapter(nn.Module):
    """``linear(x) + pos_proj(fourier(arange(seq_len)))``: (B, N, C) ->
    (B, N, num_model_channels), in f32 (the JAX package's ``nn.Dense``
    without a ``dtype`` promotes to its f32 parameters); the encodings are a
    non-persistent buffer."""

    def __init__(self, num_data_channels: int, seq_len: int, num_model_channels: int, num_frequency_bands: int = 64):
        super().__init__()
        self.num_data_channels = num_data_channels
        self.seq_len = seq_len
        self.num_input_channels = num_model_channels  # the width the encoder's cross-attention sees
        enc = fourier_position_encodings((seq_len,), num_frequency_bands)
        self.register_buffer("position_encoding", torch.from_numpy(enc), persistent=False)
        self.linear = nn.Linear(num_data_channels, num_model_channels)
        self.pos_proj = nn.Linear(enc.shape[1], num_model_channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[1], x.shape[2]
        if n != self.seq_len or c != self.num_data_channels:
            raise ValueError(f"Input series shape {(n, c)} incompatible with configured "
                             f"({self.seq_len}, {self.num_data_channels})")
        x = self.linear(x.float())
        return x + self.pos_proj(self.position_encoding)[None]


class TimeSeriesOutputAdapter(nn.Module):
    """Linear head to the target channels, in f32."""

    def __init__(self, num_output_channels: int, num_output_query_channels: int):
        super().__init__()
        self.linear = nn.Linear(num_output_query_channels, num_output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.float())


class TimeSeriesPerceiver(nn.Module):
    """``forward(x, pad_mask=None, deterministic=True, generator=None)``: the
    (B, out_len, C) forecast of series ``x`` (B, in_len, C), the decoder
    queried by ``out_len`` learned positions. ``device``, ``generator`` and
    ``dtype`` as for the text models."""

    def __init__(self, config: TimeSeriesPerceiverConfig, *, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, context = building_on(device)
        enc, dec = config.encoder, config.decoder
        c = config.num_latent_channels
        with context:
            adapter = TimeSeriesInputAdapter(enc.num_input_channels, enc.in_len, c, enc.num_frequency_bands)
            self.encoder = PerceiverEncoder(
                adapter, config.num_latents, c, activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **enc.base_kwargs(),
            )
            self.decoder = PerceiverDecoder(
                TimeSeriesOutputAdapter(dec.num_output_channels, c), TrainableQueryProvider(dec.out_len, c, dtype), c,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **dec.base_kwargs(),
            )
        self.config = config
        self.dtype = dtype
        finish_model(self, dev, [(self.encoder, enc.init_scale), (self.decoder, dec.init_scale)], generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider._query.device

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        latents = self.encoder(x, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        return self.decoder(latents, deterministic=deterministic, generator=generator)
