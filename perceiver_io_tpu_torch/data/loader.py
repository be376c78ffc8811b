"""Host-side batch iteration feeding the port's train loop (a copy of
``perceiver_io_tpu/data/loader.py``; the process index and count from
``torch.distributed``).

Batches are numpy dicts produced on the host and fed to the captured steps:
tokenization for the byte-level models is cheap, and heavy preprocessing is
done once and cached (see the data modules). Per-process sharding replaces
``split_dataset_by_node`` (reference: perceiver/data/text/c4.py:76-79).
"""

from __future__ import annotations

import queue as _queue  # module-level: close() may run during interpreter shutdown
from typing import Callable, Optional, Sequence

import numpy as np


def shard_indices_for_process(
    n: int, process_index: Optional[int] = None, process_count: Optional[int] = None
) -> np.ndarray:
    """Contiguous per-host shard of dataset indices (multi-host data
    parallelism, SURVEY §2.7 P7); by default this process's rank among
    ``torch.distributed``'s processes."""
    from perceiver_io_tpu_torch.parallel import dist

    pi = dist.process_index() if process_index is None else process_index
    pc = dist.process_count() if process_count is None else process_count
    per = n // pc
    return np.arange(pi * per, (pi + 1) * per)


class Batches:
    """Iterate a map-style dataset in (optionally shuffled) batches.

    :param dataset: supports ``len()`` and integer ``[i]`` returning an
        example (dict of arrays / scalars).
    :param collate: maps a list of examples to a batch pytree; default stacks.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        collate: Optional[Callable] = None,
        drop_last: bool = True,
        seed: int = 0,
        shard_for_processes: bool = False,
        retry=None,
        on_retry: Optional[Callable] = None,
    ):
        """``retry``: a ``training.faults.RetryPolicy`` adds bounded
        exponential-backoff retries (with jitter) around each per-example
        dataset fetch — for datasets backed by flaky remote/blob storage,
        where a transient ``OSError`` must cost milliseconds of
        ``input_wait_ms`` (it happens in the prefetch producer thread under
        the Trainer), not the run. Non-transient exception types still
        propagate immediately; exhausted retries raise
        ``FetchRetriesExhausted``. ``on_retry(attempt, exc, delay)``
        observes every retry."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate = collate or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard_for_processes = shard_for_processes
        self.retry = retry
        self.on_retry = on_retry

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        if self.shard_for_processes:
            return shard_indices_for_process(len(self.dataset))
        return np.arange(len(self.dataset))

    def _fetch(self, i: int):
        if self.retry is None:
            return self.dataset[i]
        from perceiver_io_tpu_torch.training.faults import call_with_retry

        return call_with_retry(
            lambda: self.dataset[i], self.retry, on_retry=self.on_retry
        )

    def __iter__(self):
        indices = self._indices()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(indices)
        self.epoch += 1
        end = len(indices) - self.batch_size + 1 if self.drop_last else len(indices)
        for start in range(0, max(end, 0), self.batch_size):
            batch = [self._fetch(int(i)) for i in indices[start : start + self.batch_size]]
            yield self.collate(batch)


def default_collate(examples: Sequence[dict]) -> dict:
    out = {}
    for key in examples[0]:
        vals = [np.asarray(e[key]) for e in examples]
        out[key] = np.stack(vals, axis=0)
    return out


class PrefetchIterator:
    """Overlap host-side batch production with device compute.

    A daemon producer thread pulls from the wrapped iterator into a small
    queue while the train step runs — the HOST work (dataset indexing,
    collation, masking) otherwise serializes with every step; the reference
    gets the same overlap from torch DataLoader worker processes (SURVEY
    §3.1 process boundary #2). The remaining host->device transfer is
    overlapped one layer up: ``Trainer.fit`` double-buffers device input
    (``TrainerConfig.input_double_buffer``), issuing the pinned copy of the
    NEXT batch to the card on a side stream right after dispatching the
    current step, and reports the residual blocked time as the per-window
    ``input_wait_ms`` log field. The producer runs while the consumer blocks in
    device syncs (which release the GIL). A producer exception re-raises in
    the consumer once, in order; after exhaustion (or a delivered error)
    the iterator keeps raising StopIteration per the iterator protocol.

    ``close()`` (or garbage collection — the producer holds no reference to
    this object) stops the producer. Up to ``depth + 1`` batches may have
    been pulled from the wrapped iterator but not yet consumed at that
    point; ``close()`` recovers them in order as ``self.residual`` so a
    caller reusing the SAME underlying iterator (sequential ``fit()``
    calls: resume, curriculum phases) can re-inject them instead of
    silently losing batches (ADVICE r3) — ``Trainer.fit`` does exactly
    that when the same Trainer instance sees the same iterator again.
    """

    _DONE = object()

    def __init__(self, iterator, depth: int = 2):
        import threading

        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._queue: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._leftover: list = []  # producer parks its un-put in-flight item
        self.residual: list = []  # filled by close(): produced, never consumed
        self._thread = threading.Thread(
            target=_prefetch_produce,
            args=(iter(iterator), self._queue, self._stop, self._DONE, self._leftover),
            daemon=True,
            name="batch-prefetch",
        )
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        return item

    def alive(self) -> bool:
        """True while the producer thread has not exited — it may be blocked
        inside the wrapped iterator's ``__next__`` (a slow source survives
        ``close()``'s bounded join)."""
        return self._thread.is_alive()

    def close(self) -> None:
        """Stop the producer and recover produced-but-unconsumed batches into
        ``self.residual`` (cumulative — safe to call again, e.g. after an
        ``alive()`` producer finally exits; each batch is collected once).
        The in-flight parked item is harvested only once the thread has
        actually exited, so a still-running producer cannot race the list."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        # queue contents first (produced earlier than the parked item)
        drained = []
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue.Empty:
                break
            if item is not self._DONE and not isinstance(item, BaseException):
                drained.append(item)
        self.residual = self.residual + drained
        if not self._thread.is_alive():
            self.residual = self.residual + self._leftover
            self._leftover = []

    def __del__(self):
        self.close()


def _prefetch_produce(it, out_queue, stop, done_sentinel, leftover):
    """Producer loop — a free function so the thread holds no reference to
    the PrefetchIterator (garbage-collecting the wrapper can stop it).
    An item already pulled from ``it`` when stop is raised is parked in
    ``leftover`` for ``close()`` to recover."""
    import queue

    def put_stop_aware(item) -> bool:
        while not stop.is_set():
            try:
                out_queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in it:
            if not put_stop_aware(item):
                leftover.append(item)
                return
        put_stop_aware(done_sentinel)
    except BaseException as e:  # re-raised in the consumer
        put_stop_aware(e)
