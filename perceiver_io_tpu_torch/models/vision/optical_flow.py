"""Perceiver IO optical flow: the frame pair's patch features are both the
encoder's input and the decoder's per-pixel output queries (counterpart of
``perceiver_io_tpu/models/vision/optical_flow.py``). Input is (B, 2, H, W, C),
two frames channels-last, as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.core.config import DecoderConfig, EncoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.core.modules import PerceiverDecoder, PerceiverEncoder, PerceiverIO
from perceiver_io_tpu_torch.core.position import FourierPositionEncoding, fourier_position_encodings
from perceiver_io_tpu_torch.device import DeviceLike
from perceiver_io_tpu_torch.models.base import building_on, finish_model


@dataclass
class OpticalFlowEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    num_patch_input_channels: int = 27
    num_patch_hidden_channels: int = 64
    num_frequency_bands: int = 64


@dataclass
class OpticalFlowDecoderConfig(DecoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    rescale_factor: float = 100.0


OpticalFlowConfig = PerceiverIOConfig[OpticalFlowEncoderConfig, OpticalFlowDecoderConfig]


class OpticalFlowInputAdapter(nn.Module):
    """The two frames' patch features joined channel-wise (frame-major),
    projected to ``num_patch_hidden_channels``, then the grid's Fourier
    position encodings appended: (B, 2, H, W, C) -> (B, H*W, hidden + F).

    The projection runs in f32 whatever the model's compute dtype, as the
    JAX package's ``nn.Dense`` without a ``dtype`` promotes its input to its
    f32 parameters; the encodings are a non-persistent buffer."""

    def __init__(self, image_shape: Tuple[int, int], num_patch_input_channels: int, num_patch_hidden_channels: int,
                 num_frequency_bands: int):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_patch_input_channels = num_patch_input_channels
        self.num_patch_hidden_channels = num_patch_hidden_channels
        pos = FourierPositionEncoding(self.image_shape, num_frequency_bands)
        self.num_input_channels = num_patch_hidden_channels + pos.num_position_encoding_channels()
        self.linear = nn.Linear(2 * num_patch_input_channels, num_patch_hidden_channels)
        enc = fourier_position_encodings(self.image_shape, num_frequency_bands)
        self.register_buffer("position_encoding", torch.from_numpy(enc), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if (h, w) != self.image_shape or c != self.num_patch_input_channels or t != 2:
            raise ValueError(f"Input shape {(t, h, w, c)} incompatible with configured "
                             f"(2, {self.image_shape[0]}, {self.image_shape[1]}, {self.num_patch_input_channels})")
        x = x.float().permute(0, 2, 3, 1, 4).reshape(b, h * w, t * c)
        x = self.linear(x)
        return torch.cat([x, self.position_encoding.to(x.dtype)[None].expand(b, -1, -1)], dim=-1)


class OpticalFlowOutputAdapter(nn.Module):
    """Linear head to (B, H, W, 2) flow divided by ``rescale_factor``, in f32
    (the JAX package's ``nn.Dense`` without a ``dtype``)."""

    def __init__(self, image_shape: Tuple[int, int], num_output_query_channels: int,
                 num_output_image_channels: int = 2, rescale_factor: float = 100.0):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_output_image_channels = num_output_image_channels
        self.rescale_factor = rescale_factor
        self.linear = nn.Linear(num_output_query_channels, num_output_image_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x.float()) / self.rescale_factor
        return x.reshape(x.shape[0], *self.image_shape, self.num_output_image_channels)


class OpticalFlowQueryProvider(nn.Module):
    """The output queries are the adapted input itself: one query per pixel.
    No parameters."""

    def __init__(self, num_query_channels: int):
        super().__init__()
        self.num_query_channels = num_query_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.num_query_channels:
            raise ValueError(f"adapted input of {x.shape[-1]} channels, the queries take {self.num_query_channels}")
        return x


class OpticalFlow(PerceiverIO):
    """``forward(x, deterministic=True, generator=None)`` gives the flow
    (B, H, W, 2) of frame pairs ``x`` (B, 2, H, W, 27): the encoder returns
    its adapted input beside the latents (no split-kv route), and the decoder
    queries the latents with it, one query per pixel. The encoder's
    cross-attention qk and v channels default to the adapter's width.
    ``device``, ``generator`` and ``dtype`` as for the text models."""

    def __init__(self, config: OpticalFlowConfig, *, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        dev, context = building_on(device)
        enc, dec = config.encoder, config.decoder
        with context:
            input_adapter = OpticalFlowInputAdapter(enc.image_shape, enc.num_patch_input_channels,
                                                    enc.num_patch_hidden_channels, enc.num_frequency_bands)
            width = input_adapter.num_input_channels
            encoder_kwargs = enc.base_kwargs()
            for key in ("num_cross_attention_qk_channels", "num_cross_attention_v_channels"):
                if encoder_kwargs[key] is None:
                    encoder_kwargs[key] = width
            encoder = PerceiverEncoder(
                input_adapter, config.num_latents, config.num_latent_channels,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **encoder_kwargs,
            )
            decoder = PerceiverDecoder(
                OpticalFlowOutputAdapter(dec.image_shape, width, rescale_factor=dec.rescale_factor),
                OpticalFlowQueryProvider(width), config.num_latent_channels,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype, **dec.base_kwargs(),
            )
            super().__init__(encoder, decoder)
        self.config = config
        self.dtype = dtype
        finish_model(self, dev, [(encoder, enc.init_scale), (decoder, dec.init_scale)], generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider._query.device

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_latent, x_adapted = self.encoder(x, return_adapted_input=True, deterministic=deterministic,
                                           generator=generator)
        return self.decoder(x_latent, x_adapted, deterministic=deterministic, generator=generator)
