"""Inference-side text preprocessing (a copy of
``perceiver_io_tpu/data/text/preprocessor.py``; reference:
perceiver/data/text/common.py TextPreprocessor): tokenize a batch of raw
strings into padded ``(input_ids, pad_mask)`` model inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer


class TextPreprocessor:
    def __init__(
        self,
        tokenizer: Optional[ByteTokenizer] = None,
        max_seq_len: Optional[int] = None,
        padding_side: str = "right",
        add_special_tokens: bool = False,
    ):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_seq_len = max_seq_len
        self.padding_side = padding_side
        self.add_special_tokens = add_special_tokens

    def preprocess(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        return self.preprocess_batch([text])

    def preprocess_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """:return: (input_ids (B, N) int32, pad_mask (B, N) bool — True at
        padding), capped at ``max_seq_len``."""
        seqs = self.tokenizer.batch_encode(list(texts), add_special_tokens=self.add_special_tokens)
        return self.tokenizer.pad_sequences(
            seqs, max_length=self.max_seq_len, padding_side=self.padding_side
        )
