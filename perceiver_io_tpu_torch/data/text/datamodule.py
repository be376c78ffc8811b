"""Text data modules: tokenize -> chunk -> (mask | shift) -> batches (a copy
of ``perceiver_io_tpu/data/text/datamodule.py``'s offline modules; the
process count from ``torch.distributed``).

Mirrors the reference's map-style preprocessing pipeline and task modes
(reference: perceiver/data/text/common.py:25-399): task in {clm, mlm, clf},
md5-keyed preprocessing cache, dynamic vs static masking, random-shift
training windows for CLM, and random right-truncation. In-memory
(``TextDataModule``), generated (``SyntheticTextDataModule``) and text-file
(``TextFileDataModule``) sources, and the dataset modules over HF
``datasets`` (IMDb, WikiText, Wikipedia, BookCorpus, BookCorpusOpen, enwik8):
thin ``load_source`` overrides exactly like the reference's dataset modules,
which import ``datasets`` when they load and raise its ``ImportError`` where
it is missing.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.data.loader import Batches
from perceiver_io_tpu_torch.data.text.collators import (
    DefaultCollator,
    RandomTruncateCollator,
    TokenMaskingCollator,
    WordMaskingCollator,
)
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer, encode_to_np

TASKS = ("clm", "mlm", "clf")


class _WindowDataset:
    """Random (train) or strided (valid) windows over a flat token stream —
    the CLM chunking + RandomShiftDataset equivalent
    (reference: common.py:314-340 and RandomShiftDataset)."""

    def __init__(self, data: np.ndarray, window: int, random_shift: bool, seed: int = 0):
        self.data = data
        self.window = window
        self.random_shift = random_shift
        self.rng = np.random.default_rng(seed)
        self._length = max((len(data) - 1) // window, 1)

    def __len__(self):
        return self._length

    def __getitem__(self, index):
        if self.random_shift:
            start = int(self.rng.integers(0, max(len(self.data) - self.window, 1)))
        else:
            start = min(index * self.window, max(len(self.data) - self.window, 0))
        w = self.data[start : start + self.window]
        return {"input_ids": w}


class _ListDataset:
    def __init__(self, examples: List[Dict]):
        self.examples = examples

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, index):
        return self.examples[index]


class _ClmCollator:
    """Window of max_seq_len+1 -> shifted (labels, input_ids, pad_mask)
    (reference: CLMDataset shift-by-1 + C4Collator).

    ``report_pad_free`` controls whether a batch with no padding reports
    ``pad_mask`` as None — the static signal that selects the scatter-free
    position-embedding path in the model (see adapter.embed). Default True
    (per-batch detection) is right for single-host training; **multi-host
    SPMD must pass False** (or guarantee pad-free data): the batch pytree
    structure must be identical on every host for the traced programs to
    match, and per-host detection can diverge on the stream tail."""

    def __init__(
        self,
        pad_id: int,
        window: int,
        padding_side: str = "left",
        report_pad_free: bool = True,
    ):
        self.pad_id = pad_id
        self.window = window
        self.padding_side = padding_side
        self.report_pad_free = report_pad_free

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        ids = np.full((len(examples), self.window), self.pad_id, dtype=np.int32)
        mask = np.ones((len(examples), self.window), dtype=bool)
        for r, e in enumerate(examples):
            seq = np.asarray(e["input_ids"], dtype=np.int32)[: self.window]
            if self.padding_side == "left":
                ids[r, self.window - len(seq) :] = seq
                mask[r, self.window - len(seq) :] = False
            else:
                ids[r, : len(seq)] = seq
                mask[r, : len(seq)] = False
        pad_mask = mask[:, :-1]
        if self.report_pad_free and not pad_mask.any():
            pad_mask = None  # pad-free: scatter-free embedding path
        return {
            "labels": ids[:, 1:],
            "input_ids": ids[:, :-1],
            "pad_mask": pad_mask,
        }


class TextDataModule:
    """Generic text data module.

    :param task: "clm" (causal LM), "mlm" (masked LM) or "clf" (classification).
    :param train_texts / valid_texts: in-memory sources: list of strings, or
        (text, label) tuples for clf. Subclasses may override ``load_source``
        instead.
    :param static_masking: mask once at preprocessing time instead of per
        batch (reference: common.py task/masking flags).
    """

    def __init__(
        self,
        task: str = "clm",
        tokenizer: Optional[ByteTokenizer] = None,
        max_seq_len: int = 256,
        batch_size: int = 8,
        padding_side: Optional[str] = None,
        mask_prob: float = 0.15,
        static_masking: bool = False,
        word_masking: bool = True,
        add_eos_token: bool = True,
        random_train_shift: bool = True,
        random_min_seq_len: Optional[int] = None,
        cache_dir: Optional[str] = None,
        train_texts: Optional[Sequence] = None,
        valid_texts: Optional[Sequence] = None,
        seed: int = 0,
        report_pad_free: Optional[bool] = None,
    ):
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}")
        self.task = task
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_seq_len = max_seq_len
        self.batch_size = batch_size
        # CLM requires left padding: the position shift and shifted-label
        # semantics assume pads on the left (reference: clm/lightning.py
        # asserts left padding in setup)
        self.padding_side = padding_side or ("left" if task == "clm" else "right")
        if task == "clm" and self.padding_side != "left":
            raise ValueError("task='clm' requires padding_side='left'")
        self.mask_prob = mask_prob
        self.static_masking = static_masking
        self.word_masking = word_masking
        self.add_eos_token = add_eos_token
        self.random_train_shift = random_train_shift
        self.random_min_seq_len = random_min_seq_len
        self.cache_dir = cache_dir
        self._train_texts = train_texts
        self._valid_texts = valid_texts
        self.seed = seed
        # None = auto: pad-free detection on a single host, disabled under
        # multi-host SPMD (see _ClmCollator.report_pad_free)
        self.report_pad_free = report_pad_free
        self._prepared: Optional[Dict] = None

    # ------------------------------------------------------------------ hooks

    def load_source(self) -> Dict[str, List]:
        """Return {"train": [...], "valid": [...]} where items are strings or
        (text, label) tuples. Override in dataset-specific subclasses."""
        if self._train_texts is None:
            raise ValueError("no source: pass train_texts/valid_texts or override load_source")
        return {"train": list(self._train_texts), "valid": list(self._valid_texts or [])}

    # ----------------------------------------------------------------- public

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def source_fingerprint(self) -> str:
        """Identity of the data source, part of the cache key. In-memory
        sources hash their contents; dataset subclasses should override with
        a stable name (the reference keys its cache dir per dataset module,
        common.py:164-182)."""
        h = hashlib.md5(type(self).__name__.encode())
        for texts in (self._train_texts, self._valid_texts):
            for item in texts or []:
                text = item[0] if isinstance(item, tuple) else item
                h.update(str(len(text)).encode())
                h.update(text[:256].encode())
        return h.hexdigest()

    def _cache_key(self) -> str:
        sig = json.dumps(
            {
                "source": self.source_fingerprint(),
                "task": self.task,
                "max_seq_len": self.max_seq_len,
                "tokenizer": type(self.tokenizer).__name__,
                "static_masking": self.static_masking,
                "mask_prob": self.mask_prob if self.static_masking else None,
                "add_eos": self.add_eos_token,
            },
            sort_keys=True,
        )
        return hashlib.md5(sig.encode()).hexdigest()[:16]

    def prepare(self) -> None:
        """Tokenize and chunk; cache to disk when ``cache_dir`` is set
        (reference: md5-hashed preproc cache dir, common.py:164-182)."""
        if self._prepared is not None:
            return
        cache_file = None
        if self.cache_dir:
            cache_file = Path(self.cache_dir) / f"preproc-{self._cache_key()}.npz"
            if cache_file.exists():
                self._prepared = dict(np.load(cache_file, allow_pickle=True))
                return

        source = self.load_source()
        prepared = {}
        for split, items in source.items():
            prepared.update(self._prepare_split(split, items))
        self._prepared = prepared

        if cache_file is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
            # homogeneous int streams saved natively; ragged lists as objects
            to_save = {}
            for k, v in prepared.items():
                arr = np.asarray(v) if isinstance(v, np.ndarray) else None
                if arr is not None and arr.dtype != object:
                    to_save[k] = arr
                else:
                    to_save[k] = np.asarray(v, dtype=object)
            # written aside and renamed into place (parallel/dist.py
            # prepare_once): the processes of one run prepare at once, and a
            # reader must never open a half-written cache
            from perceiver_io_tpu_torch.parallel.dist import prepare_once

            def build(tmp):
                with open(tmp, "wb") as f:
                    np.savez(f, **to_save)

            prepare_once(cache_file, build)

    def _prepare_split(self, split: str, items: List) -> Dict:
        texts, labels = [], []
        for item in items:
            if isinstance(item, tuple):
                texts.append(item[0])
                labels.append(item[1])
            else:
                texts.append(item)
        if self.task == "clf" and labels and len(labels) != len(texts):
            raise ValueError(
                f"task='clf' requires every item to be a (text, label) tuple; "
                f"got {len(labels)} labels for {len(texts)} texts in split '{split}'"
            )

        if self.task == "clm":
            eos = None
            if self.add_eos_token:
                eos = np.asarray([self.tokenizer.eos_token_id], dtype=np.int32)
            parts: List[np.ndarray] = []
            for t in texts:
                parts.append(encode_to_np(self.tokenizer, t))
                if eos is not None:
                    parts.append(eos)
            stream = np.concatenate(parts) if parts else np.empty((0,), np.int32)
            return {f"{split}_stream": stream}

        if self.task == "mlm":
            chunks, chunk_word_ids = [], []
            for t in texts:
                ids = self.tokenizer.encode(t)
                wids = self.tokenizer.word_ids(ids)
                for i in range(0, max(len(ids) - self.max_seq_len + 1, 1), self.max_seq_len):
                    chunks.append(ids[i : i + self.max_seq_len])
                    chunk_word_ids.append(wids[i : i + self.max_seq_len])
            if self.static_masking:
                # mask once at preprocessing time (reference: common.py:342-357)
                masker = WordMaskingCollator(self.tokenizer, self.mask_prob, seed=self.seed)
                masked_ids, masked_labels = [], []
                for ids, wids in zip(chunks, chunk_word_ids):
                    mids, mlabels = masker.mask_words(ids, wids)
                    masked_ids.append(mids)
                    masked_labels.append(mlabels)
                return {f"{split}_masked_ids": masked_ids, f"{split}_masked_labels": masked_labels}
            return {f"{split}_chunks": chunks, f"{split}_word_ids": chunk_word_ids}

        # clf
        encoded = [self.tokenizer.encode(t)[: self.max_seq_len] for t in texts]
        return {f"{split}_ids": encoded, f"{split}_labels": labels}

    def _batches(self, split: str, train: bool) -> Batches:
        self.prepare()
        p = self._prepared
        seed = self.seed + (0 if train else 10_000)

        if self.task == "clm":
            dataset = _WindowDataset(
                np.asarray(p[f"{split}_stream"]),
                window=self.max_seq_len + 1,
                random_shift=train and self.random_train_shift,
                seed=seed,
            )
            report_pad_free = self.report_pad_free
            if report_pad_free is None:
                from perceiver_io_tpu_torch.parallel.dist import process_count

                report_pad_free = process_count() == 1
            collate = _ClmCollator(
                self.tokenizer.pad_token_id,
                self.max_seq_len + 1,
                self.padding_side,
                report_pad_free=report_pad_free,
            )
            if train and self.random_min_seq_len is not None:
                collate = RandomTruncateCollator(collate, self.random_min_seq_len, seed=seed)
        elif self.task == "mlm":
            if self.static_masking:
                examples = [
                    {"input_ids": ids, "labels": labels}
                    for ids, labels in zip(p[f"{split}_masked_ids"], p[f"{split}_masked_labels"])
                ]
                dataset = _ListDataset(examples)
                collate = DefaultCollator(
                    self.tokenizer, max_seq_len=self.max_seq_len, padding_side=self.padding_side
                )
            else:
                examples = [
                    {"input_ids": ids, "word_ids": wids}
                    for ids, wids in zip(p[f"{split}_chunks"], p[f"{split}_word_ids"])
                ]
                dataset = _ListDataset(examples)
                masker_cls = WordMaskingCollator if self.word_masking else TokenMaskingCollator
                collate = masker_cls(
                    self.tokenizer, mask_prob=self.mask_prob, seed=seed, padding_side=self.padding_side
                )
        else:  # clf
            examples = [
                {"input_ids": ids, "label": label}
                for ids, label in zip(p[f"{split}_ids"], p[f"{split}_labels"])
            ]
            dataset = _ListDataset(examples)
            collate = DefaultCollator(
                self.tokenizer, max_seq_len=self.max_seq_len, padding_side=self.padding_side
            )

        return Batches(
            dataset,
            batch_size=self.batch_size,
            shuffle=train and self.task != "clm",  # clm train windows are already random
            collate=collate,
            seed=seed,
        )

    def train_batches(self) -> Batches:
        return self._batches("train", train=True)

    def valid_batches(self) -> Batches:
        return self._batches("valid", train=False)


# ---------------------------------------------------------- dataset modules


class HFDatasetTextDataModule(TextDataModule):
    """Base for modules backed by HF ``datasets`` (the dataset must be in the
    local HF cache where the machine has no network). Mirrors the
    reference's thin ``load_source_dataset`` overrides
    (reference: perceiver/data/text/{imdb,wikitext,...}.py). ``datasets`` is
    imported here, when the source loads: a machine without it raises its
    ``ImportError``, and no other source stands in."""

    dataset_name: str = ""
    dataset_config: Optional[str] = None
    text_column: str = "text"
    label_column: Optional[str] = None
    train_split: str = "train"
    valid_split: str = "test"

    def load_source(self) -> Dict[str, List]:
        import datasets

        ds = datasets.load_dataset(self.dataset_name, self.dataset_config)

        def extract(split):
            out = []
            for rec in ds[split]:
                if self.label_column and self.task == "clf":
                    out.append((rec[self.text_column], rec[self.label_column]))
                else:
                    out.append(rec[self.text_column])
            return out

        return {"train": extract(self.train_split), "valid": extract(self.valid_split)}


class ImdbDataModule(HFDatasetTextDataModule):
    dataset_name = "imdb"
    label_column = "label"
    num_classes = 2

    def load_source(self):
        if self.task == "clf":
            self.train_split, self.valid_split = "train", "test"
        else:
            # mlm uses the unsupervised split (reference: imdb.py)
            self.train_split, self.valid_split = "unsupervised", "test"
        return super().load_source()


class WikiTextDataModule(HFDatasetTextDataModule):
    dataset_name = "wikitext"
    dataset_config = "wikitext-103-raw-v1"
    valid_split = "validation"


class WikipediaDataModule(HFDatasetTextDataModule):
    dataset_name = "wikipedia"
    dataset_config = "20220301.en"
    valid_split = "train"


class BookCorpusDataModule(HFDatasetTextDataModule):
    dataset_name = "bookcorpus"
    valid_split = "train"


class BookCorpusOpenDataModule(HFDatasetTextDataModule):
    dataset_name = "bookcorpusopen"
    valid_split = "train"


class Enwik8DataModule(HFDatasetTextDataModule):
    dataset_name = "enwik8"
    valid_split = "train"


class SyntheticTextDataModule(TextDataModule):
    """Deterministic generated corpus for fully-offline convergence runs: a
    small template grammar with recurring entities gives byte-level structure
    a CLM/MLM can genuinely learn (well below uniform entropy), and for
    ``task="clf"`` each document draws its adjectives from a label-dependent
    sentiment pool — a learnable, generalizable two-class task. Same seed ⇒
    same corpus, so loss curves are reproducible."""

    num_classes = 2

    _SUBJECTS = ["the traveler", "a merchant", "the old captain", "my neighbor", "the engineer"]
    _VERBS = ["visited", "described", "remembered", "avoided", "praised"]
    _PLACES = ["the northern harbor", "a quiet village", "the grand market",
               "the river crossing", "an abandoned mill"]
    _POOLS = {
        0: ["dreadful", "bitter", "ruined", "gloomy", "hopeless"],
        1: ["wonderful", "bright", "thriving", "peaceful", "delightful"],
    }

    def __init__(self, num_train_docs: int = 512, num_valid_docs: int = 64,
                 sentences_per_doc: int = 30, corpus_seed: int = 7, **kwargs):
        super().__init__(**kwargs)
        self.num_train_docs = num_train_docs
        self.num_valid_docs = num_valid_docs
        self.sentences_per_doc = sentences_per_doc
        self.corpus_seed = corpus_seed

    def _doc(self, rng, label: int) -> str:
        pool = self._POOLS[label]
        sents = []
        for _ in range(self.sentences_per_doc):
            sents.append(
                f"{rng.choice(self._SUBJECTS)} {rng.choice(self._VERBS)} "
                f"{rng.choice(self._PLACES)} and found it {rng.choice(pool)}."
            )
        return " ".join(sents)

    def _generate(self, n: int, rng):
        items = []
        for _ in range(n):
            label = int(rng.integers(0, 2))
            doc = self._doc(rng, label)
            items.append((doc, label) if self.task == "clf" else doc)
        return items

    def load_source(self) -> Dict[str, List]:
        import numpy as np

        rng = np.random.default_rng(self.corpus_seed)
        return {
            "train": self._generate(self.num_train_docs, rng),
            "valid": self._generate(self.num_valid_docs, rng),
        }

    def source_fingerprint(self) -> str:
        # include the grammar itself: editing the template/pool lists must
        # invalidate the preprocessing cache, not silently serve the old corpus
        grammar = hashlib.md5(
            repr((self._SUBJECTS, self._VERBS, self._PLACES, sorted(self._POOLS.items()))).encode()
        ).hexdigest()[:10]
        return (
            f"synthetic-{grammar}-{self.corpus_seed}-{self.num_train_docs}-"
            f"{self.num_valid_docs}-{self.sentences_per_doc}-{self.task}"
        )


class TextFileDataModule(TextDataModule):
    """Fully-offline module over plain text files (one document per file, or
    one big file chunked by blank lines)."""

    def __init__(self, train_file: str, valid_file: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self.train_file = train_file
        self.valid_file = valid_file

    @staticmethod
    def _read(path: str) -> List[str]:
        text = Path(path).read_text(encoding="utf-8", errors="replace")
        docs = [d for d in text.split("\n\n") if d.strip()]
        return docs or [text]

    def load_source(self) -> Dict[str, List]:
        train = self._read(self.train_file)
        valid = self._read(self.valid_file) if self.valid_file else train[:1]
        if self.task == "clf":
            raise ValueError("TextFileDataModule does not provide labels for clf")
        return {"train": train, "valid": valid}
