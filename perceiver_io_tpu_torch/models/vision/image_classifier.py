"""Perceiver IO image classifier: pixels + Fourier position encodings ->
latents -> one learned output query -> class logits (counterpart of
``perceiver_io_tpu/models/vision/image_classifier.py``). Images are
channels-last (B, H, W, C), as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.core.adapter import ClassificationOutputAdapter, TrainableQueryProvider
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig, EncoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.core.modules import PerceiverDecoder, PerceiverEncoder, PerceiverIO
from perceiver_io_tpu_torch.core.position import FourierPositionEncoding, fourier_position_encodings
from perceiver_io_tpu_torch.device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.base import finish_model


@dataclass
class ImageEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int, int] = (224, 224, 3)
    num_frequency_bands: int = 32


ImageClassifierConfig = PerceiverIOConfig[ImageEncoderConfig, ClassificationDecoderConfig]


class ImageInputAdapter(nn.Module):
    """Flattens the pixels and appends the Fourier position encodings of the
    grid, cast to the image's dtype as the JAX package casts them; ``split``
    gives the two parts unjoined (the encoder's fused input route). The
    encodings are a non-persistent buffer: no parameter, nothing in the
    ``state_dict``, moved with the module."""

    supports_split = True

    def __init__(self, image_shape: Tuple[int, ...], num_frequency_bands: int):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_frequency_bands = num_frequency_bands
        pos = FourierPositionEncoding(self.image_shape[:-1], num_frequency_bands)
        self.num_input_channels = self.image_shape[-1] + pos.num_position_encoding_channels()
        enc = fourier_position_encodings(self.image_shape[:-1], num_frequency_bands)
        self.register_buffer("position_encoding", torch.from_numpy(enc), persistent=False)

    def split(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x_pix (B, M, C), enc (M, F))``; ``forward`` is their join."""
        b, *d = x.shape
        if tuple(d) != self.image_shape:
            raise ValueError(f"Input vision shape {tuple(d)} different from required shape {self.image_shape}")
        return x.reshape(b, -1, self.image_shape[-1]), self.position_encoding.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_pix, enc = self.split(x)
        return torch.cat([x_pix, enc[None].expand(x_pix.shape[0], -1, -1)], dim=-1)


class ImageClassifier(PerceiverIO):
    """The classifier: ``forward(x, pad_mask=None, deterministic=True)``
    gives (B, num_classes) logits for images ``x`` (B, H, W, C).

    :param device: where the parameters live — ``"cuda"`` by default; asking
        for CUDA without a card raises (pass ``device="cpu"``).
    :param generator: CPU ``torch.Generator`` for the random initialization
        (normal(0, ``init_scale``) projections and query arrays, zero biases,
        unit LayerNorms; the encoder's and the decoder's own scales); a
        generator seeded 0 when None. Weights are drawn on the CPU and then
        moved, so one seed gives the same model on every device.
    :param dtype: the compute dtype (``torch.bfloat16`` is the JAX package's
        ``ImageClassifier(config, dtype=jnp.bfloat16)``, its image
        benchmark's default): the encoder, the decoder, the query arrays and
        the classification head compute in it (``core.modules``); the
        parameters are f32 either way, and the images keep their own dtype
        up to the split K/V projection, which casts them.
    """

    def __init__(self, config: ImageClassifierConfig, *, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        enc, dec = config.encoder, config.decoder
        input_adapter = ImageInputAdapter(enc.image_shape, enc.num_frequency_bands)
        encoder_kwargs = enc.base_kwargs()
        if encoder_kwargs["num_cross_attention_qk_channels"] is None:
            # qk channels default to the adapter's output width
            encoder_kwargs["num_cross_attention_qk_channels"] = input_adapter.num_input_channels
        encoder = PerceiverEncoder(
            input_adapter, config.num_latents, config.num_latent_channels,
            activation_checkpointing=config.activation_checkpointing,
            activation_offloading=config.activation_offloading, dtype=dtype, **encoder_kwargs,
        )
        decoder = PerceiverDecoder(
            ClassificationOutputAdapter(dec.num_classes, dec.num_output_query_channels, dtype),
            TrainableQueryProvider(1, dec.num_output_query_channels, dtype),
            config.num_latent_channels,
            activation_checkpointing=config.activation_checkpointing,
            activation_offloading=config.activation_offloading, dtype=dtype, **dec.base_kwargs(),
        )
        super().__init__(encoder, decoder)
        self.config = config
        self.dtype = dtype
        finish_model(self, dev, [(encoder, encoder.init_scale), (decoder, decoder.init_scale)], generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider._query.device
