"""C4 streaming data module (a copy of ``perceiver_io_tpu/data/text/c4.py``):
the named HF-datasets-backed instance of the generic streaming pipeline
(reference: perceiver/data/text/c4.py:20-164).

Streams ``allenai/c4`` (or any HF streaming dataset) through the shuffle
window → per-process shard → tokenize → EOS-joined chunking path. Needs
network access and the ``datasets`` package at iteration time (imported
there, never at module import); ``text_iter_fn`` is the seam that replaces
the download with any iterator of strings.
"""

from __future__ import annotations

from typing import Optional

from perceiver_io_tpu_torch.data.text.streaming import StreamingTextDataModule
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer


class C4DataModule(StreamingTextDataModule):
    def __init__(
        self,
        dataset_name: str = "allenai/c4",
        dataset_config: str = "en",
        split: str = "train",
        text_column: str = "text",
        tokenizer: Optional[ByteTokenizer] = None,
        max_seq_len: int = 6144,
        min_seq_len: Optional[int] = 4096,
        batch_size: int = 8,
        shuffle_window_size: int = 10_000,
        shuffle_window_seed: int = 0,
        padding_side: str = "left",
        shard_for_processes: bool = True,
    ):
        self.dataset_name = dataset_name
        self.dataset_config = dataset_config
        self.split = split
        self.text_column = text_column

        def text_iter():
            import datasets  # only the download needs it

            ds = datasets.load_dataset(
                self.dataset_name, self.dataset_config, split=self.split, streaming=True
            )
            for record in ds:
                yield record[self.text_column]

        super().__init__(
            text_iter_fn=text_iter,
            tokenizer=tokenizer,
            max_seq_len=max_seq_len,
            min_seq_len=min_seq_len,
            batch_size=batch_size,
            shuffle_window_size=shuffle_window_size,
            shuffle_window_seed=shuffle_window_seed,
            padding_side=padding_side,
            shard_for_processes=shard_for_processes,
        )
