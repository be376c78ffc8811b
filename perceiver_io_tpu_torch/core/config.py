"""Config dataclasses of the Perceiver AR causal sequence model (counterpart
of ``perceiver_io_tpu/core/config.py``; the fields and defaults are the same,
so a config dict serialized by either package builds the other's model)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
