"""Text data for the port (counterpart of ``perceiver_io_tpu/data/text/``):
the byte tokenizer, the collators, the data modules (offline ones and the HF
``datasets`` family in ``datamodule``), the streaming pipeline
(``streaming``), C4 (``c4``) and the inference-side ``preprocessor``."""

from perceiver_io_tpu_torch.data.text.collators import (
    DefaultCollator,
    RandomTruncateCollator,
    TokenMaskingCollator,
    WordMaskingCollator,
)
from perceiver_io_tpu_torch.data.text.datamodule import (
    SyntheticTextDataModule,
    TextDataModule,
    TextFileDataModule,
)
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer

__all__ = [
    "DefaultCollator",
    "RandomTruncateCollator",
    "TokenMaskingCollator",
    "WordMaskingCollator",
    "SyntheticTextDataModule",
    "TextDataModule",
    "TextFileDataModule",
    "ByteTokenizer",
]
