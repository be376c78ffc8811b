"""Host-side prefix-dropout keep sets (a copy of
``perceiver_io_tpu/training/prefix_dropout.py``; numpy only).

The Perceiver AR prefix cross-attention dropout keeps a uniformly random
static-size subset of prefix positions each step. Drawing it on the host with
``np.argpartition`` costs microseconds and leaves the device only the
selection; ``clm_loss_fn`` forwards a ``prefix_keep_idx`` batch key to the
model. The law is the in-graph draw's: every size-``keep`` subset of the
prefix is equally likely.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np


def prefix_keep_count(prefix_len: int, dropout: float) -> int:
    """Number of prefix positions kept: the model's static count."""
    return prefix_len - int(prefix_len * dropout)


def sample_prefix_keep_idx(
    rng: np.random.Generator, batch_size: int, prefix_len: int, dropout: float
) -> np.ndarray:
    """(B, keep) int32, each row a sorted uniformly random subset."""
    keep = prefix_keep_count(prefix_len, dropout)
    if keep >= prefix_len:
        return np.tile(np.arange(prefix_len, dtype=np.int32), (batch_size, 1))
    # smallest-keep of iid uniforms = uniform subset; argpartition is O(n)
    r = rng.random((batch_size, prefix_len))
    idx = np.argpartition(r, keep, axis=1)[:, :keep]
    return np.sort(idx, axis=1).astype(np.int32)


def with_prefix_keep_idx(
    iterator: Iterable, prefix_len: int, dropout: float, seed: int = 0
) -> Iterator:
    """Augment each dict batch with a fresh ``prefix_keep_idx`` draw."""
    rng = np.random.default_rng(seed)
    for batch in iterator:
        if dropout > 0.0 and prefix_len > 0 and isinstance(batch, dict):
            batch = dict(batch)
            b = len(next(v for v in batch.values() if v is not None))
            batch["prefix_keep_idx"] = sample_prefix_keep_idx(rng, b, prefix_len, dropout)
        yield batch
