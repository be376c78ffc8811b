"""Streaming text pipeline: shuffle window -> per-process shard -> tokenize ->
concat-with-EOS -> chunk (optionally random length) -> shifted batches (a
copy of ``perceiver_io_tpu/data/text/streaming.py``; the process index and
count from ``parallel.dist``, ``torch.distributed``'s rank and world size).

Mirrors the reference's C4 streaming path
(reference: perceiver/data/text/c4.py:20-164): per-rank sharding is
per-process sharding; the shuffle window, EOS-joined concat-chunking with
optional random chunk lengths in [min_seq_len, max_seq_len], and the
shift-by-one collator are preserved."""

from __future__ import annotations

import itertools
import random
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from perceiver_io_tpu_torch.data.text.datamodule import _ClmCollator
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer, encode_to_np
from perceiver_io_tpu_torch.parallel import dist


def shuffle_window(it: Iterable, window_size: int, seed: int = 0) -> Iterator:
    """Reservoir-style shuffle over a sliding window (streaming shuffle)."""
    rng = random.Random(seed)
    buf: List = []
    for item in it:
        buf.append(item)
        if len(buf) >= window_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def shard_stream(it: Iterable, process_index: Optional[int] = None, process_count: Optional[int] = None) -> Iterator:
    """Every ``process_count``-th element, offset by ``process_index`` — the
    ``split_dataset_by_node`` equivalent (reference: c4.py:76-79). Either
    defaults to this process's place in ``torch.distributed``'s default
    group (0 of 1 without one)."""
    pi = dist.process_index() if process_index is None else process_index
    pc = dist.process_count() if process_count is None else process_count
    return itertools.islice(it, pi, None, pc)


class StreamingTextDataModule:
    """CLM batches from an unbounded text iterator (e.g. HF streaming C4).

    :param text_iter_fn: zero-arg callable returning a fresh iterator of
        strings per epoch/split.
    """

    def __init__(
        self,
        text_iter_fn: Callable[[], Iterable[str]],
        tokenizer: Optional[ByteTokenizer] = None,
        max_seq_len: int = 1024,
        min_seq_len: Optional[int] = None,
        batch_size: int = 4,
        shuffle_window_size: int = 10_000,
        shuffle_window_seed: int = 0,
        padding_side: str = "left",
        shard_for_processes: bool = True,
        report_pad_free: Optional[bool] = None,
    ):
        if min_seq_len is not None and not 0 < min_seq_len < max_seq_len:
            raise ValueError("min_seq_len must satisfy 0 < min_seq_len < max_seq_len")
        self.text_iter_fn = text_iter_fn
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_seq_len = max_seq_len
        self.min_seq_len = min_seq_len
        self.batch_size = batch_size
        self.shuffle_window_size = shuffle_window_size
        self.shuffle_window_seed = shuffle_window_seed
        self.padding_side = padding_side
        self.shard_for_processes = shard_for_processes
        # None = auto: per-batch pad-free detection on a single process;
        # disabled across processes, where every process must build batches
        # of one structure
        self.report_pad_free = report_pad_free

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def _chunks(self, randomize_len: bool) -> Iterator[np.ndarray]:
        texts = self.text_iter_fn()
        if self.shard_for_processes:
            texts = shard_stream(texts)
        texts = shuffle_window(texts, self.shuffle_window_size, seed=self.shuffle_window_seed)

        rng = random.Random(self.shuffle_window_seed + 1)

        def chunk_len():
            if randomize_len and self.min_seq_len is not None:
                return rng.randint(self.min_seq_len, self.max_seq_len) + 1
            return self.max_seq_len + 1

        # parts-list accumulation with a running length: chunk assembly
        # concatenates once per emitted chunk, not once per document
        eos = np.asarray([self.tokenizer.eos_token_id], dtype=np.int32)
        parts: List[np.ndarray] = []
        buffered = 0
        target = chunk_len()
        for text in texts:
            ids = encode_to_np(self.tokenizer, text)
            parts.append(ids)
            parts.append(eos)
            buffered += len(ids) + 1
            while buffered >= target:
                buf = np.concatenate(parts)
                while buffered >= target:
                    yield buf[:target].copy()
                    buf = buf[target:]
                    buffered -= target
                    target = chunk_len()
                parts = [buf]

    def batches(self, train: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Yield shifted {labels, input_ids, pad_mask} batches indefinitely
        (bounded by the underlying stream)."""
        report_pad_free = self.report_pad_free
        if report_pad_free is None:
            report_pad_free = dist.process_count() == 1
        collate = _ClmCollator(
            self.tokenizer.pad_token_id,
            self.max_seq_len + 1,
            self.padding_side,
            report_pad_free=report_pad_free,
        )
        chunks = self._chunks(randomize_len=train)
        while True:
            batch = list(itertools.islice(chunks, self.batch_size))
            if len(batch) < self.batch_size:
                return
            yield collate([{"input_ids": c} for c in batch])
