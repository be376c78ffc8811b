"""Sliding-window CSV data module for multivariate time-series forecasting (a
copy of ``perceiver_io_tpu/data/timeseries.py``; reference:
datamodule.py:8-55): windows of ``in_len`` input steps and
``out_len`` target steps strided over numeric CSV columns.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from perceiver_io_tpu_torch.data.loader import Batches


def read_csv_columns(
    csv_path, usecols: Sequence[int] = tuple(range(1, 8)), skip_header: int = 1
) -> np.ndarray:
    """Numeric CSV columns -> (T, C) float32 (reference: datamodule.py:12-18,
    which keeps columns 1..7)."""
    data = np.genfromtxt(
        str(csv_path), delimiter=",", skip_header=skip_header, usecols=list(usecols), dtype=np.float32
    )
    if data.ndim == 1:
        data = data[:, None]
    if np.isnan(data).any():
        bad = int(np.isnan(data).any(axis=1).sum())
        raise ValueError(
            f"{csv_path}: {bad} rows contain missing/non-numeric values in columns {list(usecols)}"
        )
    return data


class SlidingWindowDataset:
    """(T, C) series -> N strided windows of (inputs (in_len, C),
    targets (out_len, C)) (reference: datamodule.py:8-35)."""

    def __init__(self, data: np.ndarray, in_len: int, out_len: int, stride: int = 1000):
        if in_len <= 0 or out_len <= 0 or stride <= 0:
            raise ValueError("in_len, out_len and stride must be positive")
        self.data = np.asarray(data, np.float32)
        self.in_len = in_len
        self.out_len = out_len
        self.starts = list(range(0, len(self.data) - in_len - out_len + 1, stride))
        if not self.starts:
            raise ValueError(
                f"Series of length {len(self.data)} too short for "
                f"in_len={in_len} + out_len={out_len}"
            )

    def __len__(self) -> int:
        return len(self.starts)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.starts[idx]
        return {
            "x": self.data[s : s + self.in_len],
            "y": self.data[s + self.in_len : s + self.in_len + self.out_len],
        }


def _collate(examples) -> Dict[str, np.ndarray]:
    return {
        "x": np.stack([e["x"] for e in examples]),
        "y": np.stack([e["y"] for e in examples]),
    }


class CSVDataModule:
    """Train/val/test loaders over per-split CSVs (reference:
    datamodule.py:37-55). ``usecols`` selects the numeric columns
    (reference keeps 1..7 for the 7-channel ETT-style format)."""

    def __init__(
        self,
        train_path,
        val_path=None,
        test_path=None,
        in_len: int = 4096,
        out_len: int = 5000,
        stride: int = 1000,
        batch_size: int = 8,
        usecols: Sequence[int] = tuple(range(1, 8)),
        seed: int = 0,
    ):
        self.paths = {"train": train_path, "val": val_path, "test": test_path}
        self.in_len = in_len
        self.out_len = out_len
        self.stride = stride
        self.batch_size = batch_size
        self.usecols = tuple(usecols)
        self.seed = seed
        self._datasets: Dict[str, SlidingWindowDataset] = {}

    @property
    def num_channels(self) -> int:
        return len(self.usecols)

    def dataset(self, split: str) -> SlidingWindowDataset:
        if split not in self._datasets:
            path = self.paths.get(split)
            if path is None:
                raise ValueError(f"No CSV configured for split {split!r}")
            data = read_csv_columns(path, usecols=self.usecols)
            self._datasets[split] = SlidingWindowDataset(
                data, self.in_len, self.out_len, self.stride
            )
        return self._datasets[split]

    def train_batches(self) -> Batches:
        return Batches(
            self.dataset("train"),
            batch_size=self.batch_size,
            shuffle=True,
            seed=self.seed,
            collate=_collate,
        )

    def valid_batches(self) -> Batches:
        return Batches(
            self.dataset("val"),
            batch_size=self.batch_size,
            shuffle=False,
            collate=_collate,
            drop_last=False,
        )

    def test_batches(self) -> Batches:
        return Batches(
            self.dataset("test"),
            batch_size=self.batch_size,
            shuffle=False,
            collate=_collate,
            drop_last=False,
        )
