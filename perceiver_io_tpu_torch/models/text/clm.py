"""Causal language model — a specialization of the causal sequence model
(counterpart of ``perceiver_io_tpu/models/text/clm.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_tpu_torch.core.config import CausalSequenceModelConfig
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel


@dataclass
class CausalLanguageModelConfig(CausalSequenceModelConfig):
    pass


class CausalLanguageModel(CausalSequenceModel):
    pass
