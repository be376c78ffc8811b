"""Process-role helpers (counterpart of ``perceiver_io_tpu/parallel/dist.py``:
``process_index``, ``process_count``, ``is_main_process``,
``main_process_only``, ``maybe_initialize_distributed``, and
``prepare_once``, the race-free build of a cached data file).

The JAX package reads ``jax.process_index()``; the port reads the rank and
world size of ``torch.distributed``'s default group, and is process 0 of 1
when no group is initialised. Host-side writes (metric CSVs, event logs,
config JSON, checkpoints) happen on process 0 alone.

``maybe_initialize_distributed`` is the multi-process entry point: under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) it starts the default group, NCCL on the card after
``torch.cuda.set_device(LOCAL_RANK)``, gloo only where the caller names the
CPU. A group that cannot start raises: nothing drops to one process. Every
group the port starts has a finite timeout (``GROUP_TIMEOUT``), so a hung
collective fails instead of blocking forever.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Callable, Optional, TypeVar

import torch
import torch.distributed as dist

F = TypeVar("F", bound=Callable)

# how long a collective may wait for its peers before the group fails
GROUP_TIMEOUT = datetime.timedelta(seconds=float(os.environ.get("PIO_GROUP_TIMEOUT_S", "600")))


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on exactly one process of a multi-process program (rank 0);
    always True in a single process."""
    return process_index() == 0


def main_process_only(fn: F) -> F:
    """Run ``fn`` only on process 0, returning None elsewhere: for host-side
    side effects (file writes, stdout). Do NOT wrap work that enters a
    collective (every process must)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not is_main_process():
            return None
        return fn(*args, **kwargs)

    return wrapper  # type: ignore[return-value]


def initialize(device="cuda", rank: int = 0, world_size: int = 1, init_method: Optional[str] = None,
               store=None) -> None:
    """Start the default group for ``device`` (NCCL on the card, gloo on the
    CPU) with ``GROUP_TIMEOUT``. On the card the process's device is
    ``LOCAL_RANK`` (0 when unset) first. ``store`` (e.g. a ``FileStore``)
    or ``init_method`` is the rendezvous; with neither, a one-process group
    rendezvouses in memory (a ``HashStore``) and a larger one reads torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``)."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if store is None and init_method is None:
        if world_size == 1:
            store = dist.HashStore()
        else:
            init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank, world_size=world_size,
                            timeout=GROUP_TIMEOUT, **kwargs)


def maybe_initialize_distributed(device="cuda") -> bool:
    """Start the default group when torchrun's coordinates are set
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the card's
    ``LOCAL_RANK``), as the JAX function does when ``JAX_COORDINATOR_ADDRESS``
    is set. Returns True when a group was started, False when the
    coordinates are absent or a group is already up (a second call is a
    no-op). NCCL on the card, gloo where ``device`` is the CPU; a failure
    raises."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"RANK and WORLD_SIZE are set but {', '.join(missing)} is not: launch with torchrun, "
                         "or set all of RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    initialize(device, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return True


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
