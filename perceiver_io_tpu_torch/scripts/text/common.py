"""Shared text-data CLI args: dataset selector → data module (a copy of
``perceiver_io_tpu/scripts/text/common.py``; reference: one module class per
dataset, perceiver/data/text/*.py; the reference CLIs pick one via
``--data=<ClassName>``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from perceiver_io_tpu_torch.data.text.datamodule import (
    BookCorpusDataModule,
    BookCorpusOpenDataModule,
    Enwik8DataModule,
    ImdbDataModule,
    SyntheticTextDataModule,
    TextDataModule,
    TextFileDataModule,
    WikipediaDataModule,
    WikiTextDataModule,
)

DATASETS = {
    "wikitext": WikiTextDataModule,
    "imdb": ImdbDataModule,
    "wikipedia": WikipediaDataModule,
    "bookcorpus": BookCorpusDataModule,
    "bookcorpusopen": BookCorpusOpenDataModule,
    "enwik8": Enwik8DataModule,
    "textfile": TextFileDataModule,
    "synthetic": SyntheticTextDataModule,
}


@dataclass
class TextDataArgs:
    dataset: str = "wikitext"
    train_file: Optional[str] = None  # for dataset=textfile
    valid_file: Optional[str] = None
    max_seq_len: int = 4096
    batch_size: int = 8
    mask_prob: float = 0.15
    static_masking: bool = False
    word_masking: bool = True
    add_eos_token: bool = True
    random_train_shift: bool = True
    random_min_seq_len: Optional[int] = None
    cache_dir: Optional[str] = ".cache/text"
    seed: int = 0


def build_text_datamodule(args: TextDataArgs, task: str) -> TextDataModule:
    if args.dataset not in DATASETS:
        raise ValueError(f"unknown dataset {args.dataset!r}; choose from {sorted(DATASETS)}")
    kwargs = dict(
        task=task,
        max_seq_len=args.max_seq_len,
        batch_size=args.batch_size,
        mask_prob=args.mask_prob,
        static_masking=args.static_masking,
        word_masking=args.word_masking,
        add_eos_token=args.add_eos_token,
        random_train_shift=args.random_train_shift,
        random_min_seq_len=args.random_min_seq_len,
        cache_dir=args.cache_dir,
        seed=args.seed,
    )
    cls = DATASETS[args.dataset]
    if cls is TextFileDataModule:
        if args.train_file is None:
            raise ValueError("dataset=textfile requires --data.train_file")
        return cls(train_file=args.train_file, valid_file=args.valid_file, **kwargs)
    return cls(**kwargs)
