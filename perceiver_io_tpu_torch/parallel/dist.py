"""Process-role helpers (counterpart of ``perceiver_io_tpu/parallel/dist.py``:
``process_index``, ``process_count``, ``is_main_process``, and
``prepare_once``, the race-free build of a cached data file).

The JAX package reads ``jax.process_index()``; the port reads the rank and
world size of ``torch.distributed``'s default group, and is process 0 of 1
when no group is initialised. Host-side writes (metric CSVs, event logs,
config JSON, checkpoints' sidecars) happen on process 0 alone.
"""

from __future__ import annotations

import os
from typing import Callable

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on exactly one process of a multi-process program (rank 0);
    always True in a single process."""
    return process_index() == 0


STALE_TMP_AGE_SECONDS = 24 * 3600


def prepare_once(target, build: Callable[[object], None]) -> None:
    """Race-free build-if-missing for a DETERMINISTIC cached file or
    directory: build into a process-private temp sibling, then atomically
    rename into place. Concurrent processes (multi-host on a shared
    filesystem, or racing local workers) may build redundantly, but the
    atomic rename means readers never observe a half-written cache and
    last-writer-wins is harmless because the content is identical. Hosts
    with per-host local disks (no shared cache path) each build their own
    copy, exactly like plain build-if-missing.

    ``build(tmp_path)`` must write the artifact at ``tmp_path`` (creating it
    as a file or directory itself).

    Temp names are host-unique (hostname + pid + random suffix — pid alone
    collides across hosts on a shared filesystem), and the sweep of leftovers
    from crashed builds only reclaims temps older than
    ``STALE_TMP_AGE_SECONDS``: a young temp is very likely a concurrent
    process still building, and rmtree-ing it mid-write would crash that
    build.
    """
    import shutil
    import socket
    import time
    import uuid
    from pathlib import Path

    target = Path(target)
    if target.exists():
        return
    target.parent.mkdir(parents=True, exist_ok=True)
    # sweep stale temps from CRASHED builds only (age-gated: the target being
    # missing is exactly when a concurrent process may still be writing)
    now = time.time()
    for stale in target.parent.glob(f".{target.name}.tmp-*"):
        try:
            if now - stale.stat().st_mtime < STALE_TMP_AGE_SECONDS:
                continue
        except OSError:
            continue  # vanished under us (its writer finished or cleaned up)
        if stale.is_dir():
            shutil.rmtree(stale, ignore_errors=True)
        else:
            try:
                stale.unlink()
            except OSError:
                pass

    suffix = f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = target.with_name(f".{target.name}.tmp-{suffix}")

    def cleanup_tmp():
        if tmp.is_dir():
            shutil.rmtree(tmp, ignore_errors=True)
        elif tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass

    try:
        build(tmp)
        try:
            tmp.replace(target)
        except OSError:
            if not target.exists():  # concurrent creation is fine; else re-raise
                raise
            cleanup_tmp()
    except BaseException:
        cleanup_tmp()
        raise
