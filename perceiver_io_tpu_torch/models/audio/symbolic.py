"""Symbolic audio (MIDI event) model — the causal sequence model over the
MIDI event vocabulary (counterpart of
``perceiver_io_tpu/models/audio/symbolic.py``; reference:
perceiver/model/audio/symbolic/backend.py:6-13)."""

from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_tpu_torch.core.config import CausalSequenceModelConfig
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel


@dataclass
class SymbolicAudioModelConfig(CausalSequenceModelConfig):
    vocab_size: int = 389  # 128 note_on + 128 note_off + 100 time_shift + 32 velocity + PAD
    max_seq_len: int = 6144
    max_latents: int = 2048


class SymbolicAudioModel(CausalSequenceModel):
    pass
