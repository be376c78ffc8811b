"""Batch collators producing ``{"labels", "input_ids", "pad_mask"}`` batches
(the reference's (labels, input_ids, pad_mask) triple as a dict —
reference: perceiver/data/text/collator.py:16-152); a copy of
``perceiver_io_tpu/data/text/collators.py``, numpy on the host."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.training.losses import IGNORE_INDEX


class DefaultCollator:
    """Pad to the batch max, capped at ``max_seq_len``
    (reference: collator.py:45-84). Keeps scalar labels under ``label``."""

    def __init__(self, tokenizer, max_seq_len: Optional[int] = None, padding_side: str = "right"):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.padding_side = padding_side

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer.pad_sequences(
            [e["input_ids"] for e in examples],
            max_length=self.max_seq_len,
            padding_side=self.padding_side,
        )
        batch = {"input_ids": ids, "pad_mask": mask}
        if "labels" in examples[0]:
            labels, _ = _pad_labels(
                [e["labels"] for e in examples], ids.shape[1], self.padding_side
            )
            batch["labels"] = labels
        if "label" in examples[0]:
            batch["label"] = np.asarray([e["label"] for e in examples], dtype=np.int32)
        return batch


class RandomTruncateCollator:
    """Randomly drop tokens from the right down to at least ``min_seq_len``
    (a CLM regularizer — reference: collator.py:25-42)."""

    def __init__(self, collator, min_seq_len: int, seed: int = 0):
        self.collator = collator
        self.min_seq_len = min_seq_len
        self.rng = np.random.default_rng(seed)

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        batch = self.collator(examples)
        seq_len = batch["input_ids"].shape[1]
        if seq_len <= self.min_seq_len:
            return batch
        drop = int(self.rng.integers(1, seq_len - self.min_seq_len + 1))
        for key in ("labels", "input_ids", "pad_mask"):
            if batch.get(key) is not None:  # pad_mask is None for pad-free batches
                batch[key] = batch[key][:, :-drop]
        return batch


class WordMaskingCollator:
    """Whole-word masking, 80/10/10 mask/random/keep per selected word
    (reference: collator.py:87-145). Requires examples with ``word_ids``."""

    def __init__(self, tokenizer, mask_prob: float = 0.15, seed: int = 0, padding_side: str = "right"):
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        self.rng = np.random.default_rng(seed)
        self.padding_side = padding_side

    def mask_words(self, input_ids: List[int], word_ids: List[Optional[int]]):
        input_ids = list(input_ids)
        labels = [IGNORE_INDEX] * len(input_ids)

        mapping = defaultdict(list)
        current_word_index = -1
        current_word_id = None
        for idx, word_id in enumerate(word_ids):
            if word_id is not None:
                if word_id != current_word_id:
                    current_word_id = word_id
                    current_word_index += 1
                mapping[current_word_index].append(idx)

        mask = self.rng.binomial(1, self.mask_prob, len(mapping))
        for word_index in np.where(mask)[0]:
            rand_nr = self.rng.random(2)
            for idx in mapping[word_index]:
                labels[idx] = input_ids[idx]
                if rand_nr[0] < 0.8:
                    input_ids[idx] = self.tokenizer.mask_token_id
                elif rand_nr[1] < 0.5:
                    input_ids[idx] = int(self.rng.integers(self.tokenizer.vocab_size))
                # else: leave unchanged
        return input_ids, labels

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        masked = []
        for e in examples:
            ids, labels = self.mask_words(e["input_ids"], e["word_ids"])
            masked.append({"input_ids": ids, "labels": labels})
        ids, mask = self.tokenizer.pad_sequences(
            [m["input_ids"] for m in masked], padding_side=self.padding_side
        )
        labels, _ = _pad_labels([m["labels"] for m in masked], ids.shape[1], self.padding_side)
        return {"labels": labels, "input_ids": ids, "pad_mask": mask}


class TokenMaskingCollator:
    """Token-level masking, 80/10/10 (HF DataCollatorForLanguageModeling
    semantics — reference: collator.py:148-152)."""

    def __init__(self, tokenizer, mask_prob: float = 0.15, seed: int = 0, padding_side: str = "right"):
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        self.rng = np.random.default_rng(seed)
        self.padding_side = padding_side

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        ids, pad_mask = self.tokenizer.pad_sequences(
            [e["input_ids"] for e in examples], padding_side=self.padding_side
        )
        labels = np.full_like(ids, IGNORE_INDEX)
        special = ids < self.tokenizer.num_special_tokens

        selected = (self.rng.random(ids.shape) < self.mask_prob) & ~special & ~pad_mask
        labels[selected] = ids[selected]

        roll = self.rng.random(ids.shape)
        ids = np.where(selected & (roll < 0.8), self.tokenizer.mask_token_id, ids)
        random_ids = self.rng.integers(0, self.tokenizer.vocab_size, size=ids.shape)
        ids = np.where(selected & (roll >= 0.8) & (roll < 0.9), random_ids, ids)
        return {"labels": labels, "input_ids": ids.astype(np.int32), "pad_mask": pad_mask}


def _pad_labels(label_seqs: Sequence[Sequence[int]], length: int, padding_side: str):
    labels = np.full((len(label_seqs), length), IGNORE_INDEX, dtype=np.int32)
    for r, seq in enumerate(label_seqs):
        seq = list(seq)[:length]
        if padding_side == "right":
            labels[r, : len(seq)] = seq
        else:
            labels[r, length - len(seq) :] = seq
    return labels, None
