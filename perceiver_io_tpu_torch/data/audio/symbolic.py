"""Symbolic audio data module: MIDI files -> flat int16 token memmap with
example separators -> random-window sampling -> shifted batches (a numpy copy
of ``perceiver_io_tpu/data/audio/symbolic.py``).

Behavioral parity with the reference
(reference: perceiver/data/audio/symbolic.py:16-232): separator id -1, PAD
388, vocab 389; each sample draws a random window of max_seq_len+1 tokens,
keeps the longest separator-free piece, optionally truncates to a random
length in [min_seq_len, max_seq_len]; the collator left/right-pads to
max_seq_len+1 and emits shifted (labels, input_ids, pad_mask)."""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perceiver_io_tpu_torch.data.audio.midi import PAD_ID, VOCAB_SIZE, encode_midi_files
from perceiver_io_tpu_torch.data.loader import Batches

EXAMPLE_SEPARATOR = -1


class SymbolicAudioNumpyDataset:
    """(reference: symbolic.py:160-190)"""

    def __init__(
        self,
        data: np.ndarray,
        max_seq_len: int,
        min_seq_len: Optional[int] = None,
        seed: int = 0,
    ):
        self._data = data
        self._max_seq_len = max_seq_len
        self._min_seq_len = min_seq_len
        self._rng = np.random.default_rng(seed)
        self._length = self._data.shape[0] // self._max_seq_len

    def __len__(self):
        return self._length

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        start = int(self._rng.integers(0, self._data.shape[0] - self._max_seq_len))
        sample = np.asarray(self._data[start : start + self._max_seq_len], dtype=np.int64)

        if EXAMPLE_SEPARATOR in sample:
            pieces = np.split(sample, np.where(sample == EXAMPLE_SEPARATOR)[0])
            example = max(pieces, key=len)
            example = example[example != EXAMPLE_SEPARATOR]
        else:
            example = sample

        if self._min_seq_len is not None and self._min_seq_len < len(example):
            chunk_length = int(self._rng.integers(self._min_seq_len, self._max_seq_len))
            example = example[:chunk_length]
        return {"input_ids": example}


class SymbolicAudioCollator:
    """Pad to max_seq_len+1 then shift (reference: symbolic.py:193-232)."""

    def __init__(self, max_seq_len: int, pad_token: int = PAD_ID, padding_side: str = "left"):
        if padding_side not in ("left", "right"):
            raise ValueError(f"Invalid padding side '{padding_side}'")
        self._max_seq_len = max_seq_len
        self._pad_token = pad_token
        self._padding_side = padding_side

    def __call__(self, examples: List[Dict]) -> Dict[str, np.ndarray]:
        n = len(examples)
        ids = np.full((n, self._max_seq_len), self._pad_token, dtype=np.int32)
        for r, e in enumerate(examples):
            seq = np.asarray(e["input_ids"])[: self._max_seq_len]
            if self._padding_side == "left":
                ids[r, self._max_seq_len - len(seq) :] = seq
            else:
                ids[r, : len(seq)] = seq
        pad_mask = ids == self._pad_token
        return {
            "labels": ids[:, 1:],
            "input_ids": ids[:, :-1],
            "pad_mask": pad_mask[:, :-1],
        }


class SymbolicAudioDataModule:
    _VOCAB_SIZE = VOCAB_SIZE

    def __init__(
        self,
        dataset_dir: str,
        max_seq_len: int,
        min_seq_len: Optional[int] = None,
        padding_side: str = "left",
        batch_size: int = 16,
        preproc_workers: int = 1,
        seed: int = 0,
    ):
        if min_seq_len is not None and not (0 < min_seq_len < max_seq_len):
            raise ValueError(
                "Invalid data configuration supplied. "
                "Parameter 'min_seq_len' must adhere to 0 < min_seq_len < max_seq_len."
            )
        self.dataset_dir = Path(dataset_dir)
        self.max_seq_len = max_seq_len
        self.min_seq_len = min_seq_len
        self.padding_side = padding_side
        self.batch_size = batch_size
        self.preproc_workers = preproc_workers
        self.seed = seed
        self._collator = SymbolicAudioCollator(
            max_seq_len=max_seq_len + 1, pad_token=PAD_ID, padding_side=padding_side
        )

    @property
    def vocab_size(self):
        return self._VOCAB_SIZE

    @property
    def preproc_dir(self) -> Path:
        return self.dataset_dir / "preproc"

    @property
    def train_data_file(self) -> Path:
        return self.preproc_dir / "train.bin"

    @property
    def valid_data_file(self) -> Path:
        return self.preproc_dir / "valid.bin"

    def load_source_dataset(self) -> Dict[str, Path]:
        """Return {"train": dir, "valid": dir} of directories with .mid files.
        Override in dataset-specific subclasses (GiantMIDI, Maestro)."""
        raise NotImplementedError(
            "`load_source_dataset` must return a dictionary with keys 'train' and 'valid'."
        )

    def prepare_data(self) -> None:
        # atomic rename-into-place (parallel/dist.py prepare_once): racing
        # processes never observe a half-flushed memmap or crash on mkdir
        from perceiver_io_tpu_torch.parallel.dist import prepare_once

        def build(tmp_dir) -> None:
            dataset = self.load_source_dataset()
            encoded = {}
            for split in ("train", "valid"):
                d = Path(dataset[split])
                if not d.exists():
                    raise ValueError(f"Invalid directory supplied. Directory '{d}' does not exist.")
                files = list(d.rglob("**/*.mid")) + list(d.rglob("**/*.midi"))
                encoded[split] = encode_midi_files(files, num_workers=self.preproc_workers)

            random.Random(self.seed).shuffle(encoded["train"])
            tmp_dir.mkdir(parents=True)
            names = (("train", self.train_data_file.name), ("valid", self.valid_data_file.name))
            for split, name in names:
                flat = np.concatenate(
                    [np.append(ids, [EXAMPLE_SEPARATOR]) for ids in encoded[split]]
                ).astype(np.int16)
                fp = np.memmap(str(tmp_dir / name), dtype=np.int16, mode="w+", shape=flat.shape)
                fp[:] = flat[:]
                fp.flush()

        prepare_once(self.preproc_dir, build)

    def _dataset(self, data_file: Path, train: bool) -> SymbolicAudioNumpyDataset:
        data = np.memmap(str(data_file), dtype=np.int16, mode="r")
        return SymbolicAudioNumpyDataset(
            data,
            max_seq_len=self.max_seq_len + 1,
            min_seq_len=self.min_seq_len + 1 if (train and self.min_seq_len) else None,
            seed=self.seed if train else self.seed + 10_000,
        )

    def train_batches(self) -> Batches:
        return Batches(
            self._dataset(self.train_data_file, train=True),
            batch_size=self.batch_size,
            shuffle=False,  # windows are already random
            collate=self._collator,
        )

    def valid_batches(self) -> Batches:
        return Batches(
            self._dataset(self.valid_data_file, train=False),
            batch_size=self.batch_size,
            shuffle=False,
            collate=self._collator,
        )


# ---------------------------------------------------------- dataset modules


class DirectorySymbolicAudioDataModule(SymbolicAudioDataModule):
    """Local-directory source: ``<dataset_dir>/{train,valid}`` of .mid files.
    The fully-offline module."""

    def load_source_dataset(self) -> Dict[str, Path]:
        return {"train": self.dataset_dir / "train", "valid": self.dataset_dir / "valid"}


class SyntheticSymbolicAudioDataModule(SymbolicAudioDataModule):
    """Deterministic generated token stream for fully-offline convergence
    runs: pieces are built from a small bank of note motifs (note_on /
    time_shift / velocity / note_off events in their valid vocabulary ranges)
    repeated with variation, so a causal model can genuinely learn the event
    grammar and motif statistics — far below the uniform log(389) entropy."""

    def __init__(self, *args, num_train_pieces: int = 96, num_valid_pieces: int = 16,
                 corpus_seed: int = 7, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_train_pieces = num_train_pieces
        self.num_valid_pieces = num_valid_pieces
        self.corpus_seed = corpus_seed

    @staticmethod
    def _motifs(rng) -> List[np.ndarray]:
        # event vocabulary layout (data/audio/midi.py): note_on 0..127,
        # note_off 128..255, time_shift 256..355, velocity 356..387
        banks = []
        for _ in range(8):
            pitches = rng.integers(40, 88, size=4)
            events = []
            for p in pitches:
                events += [356 + int(rng.integers(8, 24)),  # velocity
                           int(p),                          # note_on
                           256 + int(rng.integers(5, 20)),  # time_shift
                           128 + int(p)]                    # note_off
            banks.append(np.asarray(events, np.int16))
        return banks

    def _piece(self, rng, motifs) -> np.ndarray:
        idx = rng.integers(0, len(motifs), size=int(rng.integers(40, 80)))
        parts = []
        for i in idx:
            m = motifs[i].copy()
            if rng.random() < 0.25:  # transpose the motif by a small interval
                shift = int(rng.integers(-3, 4))
                on = (m < 128)
                off = (m >= 128) & (m < 256)
                m[on] = np.clip(m[on] + shift, 0, 127)
                m[off] = np.clip(m[off] + shift, 128, 255)
            parts.append(m)
        return np.concatenate(parts)

    def prepare_data(self) -> None:
        # atomic rename-into-place: concurrent processes (multi-host shared
        # filesystem, racing local workers) never observe a half-written
        # cache; redundant builds are harmless — content is deterministic
        # (parallel/dist.py prepare_once)
        from perceiver_io_tpu_torch.parallel.dist import prepare_once

        def build(tmp_dir) -> None:
            rng = np.random.default_rng(self.corpus_seed)
            motifs = self._motifs(rng)
            pieces = {
                "train": [self._piece(rng, motifs) for _ in range(self.num_train_pieces)],
                "valid": [self._piece(rng, motifs) for _ in range(self.num_valid_pieces)],
            }
            tmp_dir.mkdir(parents=True)
            names = (("train", self.train_data_file.name), ("valid", self.valid_data_file.name))
            for split, name in names:
                flat = np.concatenate(
                    [np.append(ids, [EXAMPLE_SEPARATOR]) for ids in pieces[split]]
                ).astype(np.int16)
                fp = np.memmap(str(tmp_dir / name), dtype=np.int16, mode="w+", shape=flat.shape)
                fp[:] = flat[:]
                fp.flush()

        prepare_once(self.preproc_dir, build)


class _ArchiveSymbolicAudioDataModule(SymbolicAudioDataModule):
    """Base for archive-backed datasets (reference:
    perceiver/data/audio/{giantmidi_piano,maestro_v3}.py — zip download +
    extract). The module downloads nothing: the archive (or its extracted
    tree) must already exist under ``dataset_dir``; ``prepare_data`` then
    splits deterministically."""

    archive_name: str = ""
    extracted_subdir: str = ""
    valid_fraction: float = 0.05

    @property
    def extracted_dir(self) -> Path:
        return self.dataset_dir / self.extracted_subdir

    def _extract(self) -> None:
        if self.extracted_dir.exists():
            return
        archive = self.dataset_dir / self.archive_name
        if not archive.exists():
            raise FileNotFoundError(
                f"{archive} not found; download it first (the module reads a local archive only). "
                f"Alternatively use DirectorySymbolicAudioDataModule over local .mid dirs."
            )
        import zipfile

        with zipfile.ZipFile(archive) as zf:
            zf.extractall(self.dataset_dir)

    def _split_files(self) -> Dict[str, List[Path]]:
        files = sorted(self.extracted_dir.rglob("*.mid")) + sorted(self.extracted_dir.rglob("*.midi"))
        random.Random(self.seed).shuffle(files)
        n_valid = max(1, int(len(files) * self.valid_fraction))
        return {"train": files[n_valid:], "valid": files[:n_valid]}

    def load_source_dataset(self) -> Dict[str, Path]:
        self._extract()
        # materialize split directories of symlinks so the base preproc
        # (directory-driven) applies unchanged
        import hashlib
        import shutil

        split_root = self.dataset_dir / "splits"
        splits = self._split_files()
        for split, files in splits.items():
            d = split_root / split
            if d.exists():  # stale links from a previous (possibly different) split
                shutil.rmtree(d)
            d.mkdir(parents=True)
            for f in files:
                digest = hashlib.md5(str(f).encode()).hexdigest()[:12]
                link = d / f"{digest}-{f.name}"
                try:
                    link.symlink_to(f.resolve())
                except OSError:
                    shutil.copy(f, link)
        return {"train": split_root / "train", "valid": split_root / "valid"}


class GiantMidiPianoDataModule(_ArchiveSymbolicAudioDataModule):
    """GiantMIDI-Piano (reference: perceiver/data/audio/giantmidi_piano.py)."""

    archive_name = "midis_v1.2.zip"
    extracted_subdir = "midis"


class MaestroV3DataModule(_ArchiveSymbolicAudioDataModule):
    """Maestro V3 (reference: perceiver/data/audio/maestro_v3.py — split by
    the metadata json when present, else deterministic fraction split)."""

    archive_name = "maestro-v3.0.0-midi.zip"
    extracted_subdir = "maestro-v3.0.0"

    def _split_files(self) -> Dict[str, List[Path]]:
        meta = self.extracted_dir / "maestro-v3.0.0.json"
        if not meta.exists():
            return super()._split_files()
        import json

        with open(meta) as f:
            m = json.load(f)
        # column-oriented json: {"split": {idx: name}, "midi_filename": {idx: path}}
        splits: Dict[str, List[Path]] = {"train": [], "valid": []}
        for idx, split in m["split"].items():
            path = self.extracted_dir / m["midi_filename"][idx]
            key = "valid" if split == "validation" else ("train" if split == "train" else None)
            if key and path.exists():
                splits[key].append(path)
        return splits
