"""Config dataclasses of the Perceiver IO encoder/decoder and of the
Perceiver AR causal sequence model (counterpart of
``perceiver_io_tpu/core/config.py``; the fields and defaults are the same,
so a config dict serialized by either package builds the other's model)."""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Generic, Optional, TypeVar


def _base_kwargs(config, base_class, exclude):
    """The fields of ``base_class`` except ``exclude``, read from ``config``."""
    return {f.name: getattr(config, f.name) for f in fields(base_class) if f.name not in exclude}


@dataclass
class EncoderConfig:
    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    num_cross_attention_layers: int = 1
    first_cross_attention_layer_shared: bool = False
    cross_attention_widening_factor: int = 1
    num_self_attention_heads: int = 8
    num_self_attention_qk_channels: Optional[int] = None
    num_self_attention_v_channels: Optional[int] = None
    num_self_attention_layers_per_block: int = 8
    num_self_attention_blocks: int = 1
    first_self_attention_block_shared: bool = True
    self_attention_widening_factor: int = 1
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False

    def base_kwargs(self, exclude=("freeze",)):
        return _base_kwargs(self, EncoderConfig, exclude)


@dataclass
class DecoderConfig:
    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    cross_attention_widening_factor: int = 1
    cross_attention_residual: bool = True
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False

    def base_kwargs(self, exclude=("freeze",)):
        return _base_kwargs(self, DecoderConfig, exclude)


@dataclass
class ClassificationDecoderConfig(DecoderConfig):
    num_output_queries: int = 1
    num_output_query_channels: int = 256
    num_classes: int = 100


E = TypeVar("E", bound=EncoderConfig)
D = TypeVar("D", bound=DecoderConfig)


@dataclass
class PerceiverIOConfig(Generic[E, D]):
    encoder: E
    decoder: D
    num_latents: int
    num_latent_channels: int
    activation_checkpointing: bool = False
    activation_offloading: bool = False


@dataclass
class PerceiverARConfig:
    num_heads: int = 8
    max_heads_parallel: Optional[int] = None
    num_self_attention_layers: int = 8
    num_self_attention_rotary_layers: int = 1
    self_attention_widening_factor: int = 4
    cross_attention_widening_factor: int = 4
    cross_attention_dropout: float = 0.5
    prefix_dropout_mode: str = "gather"
    post_attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    activation_checkpointing: bool = False
    activation_offloading: bool = False


@dataclass
class CausalSequenceModelConfig(PerceiverARConfig):
    vocab_size: int = 262
    max_seq_len: int = 4096
    max_latents: int = 512
    num_channels: int = 512
    output_norm: bool = False
    output_bias: bool = True
    abs_pos_emb: bool = True
    init_scale: float = 0.02
