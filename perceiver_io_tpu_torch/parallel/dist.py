"""Process-role helpers (counterpart of ``perceiver_io_tpu/parallel/dist.py``:
``process_index``, ``process_count``, ``is_main_process``).

The JAX package reads ``jax.process_index()``; the port reads the rank and
world size of ``torch.distributed``'s default group, and is process 0 of 1
when no group is initialised. Host-side writes (metric CSVs, event logs,
config JSON, checkpoints' sidecars) happen on process 0 alone.
"""

from __future__ import annotations

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on exactly one process of a multi-process program (rank 0);
    always True in a single process."""
    return process_index() == 0
