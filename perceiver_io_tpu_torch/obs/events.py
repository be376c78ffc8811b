"""Structured run events: a JSONL event sink and the run manifest
(counterpart of ``perceiver_io_tpu/obs/events.py``: ``EventLog``,
``config_hash``, ``write_run_manifest``, ``event_shards``,
``read_event_file``, ``merged_events``).

``events.jsonl`` is the machine-readable companion of ``metrics.csv``: one
JSON object per line, each carrying ``ts`` (epoch seconds), ``event`` (the
kind) and ``schema_version``. The trainer emits ``fit_start`` / ``log`` /
``compile`` (a CUDA graph capture, ``obs.recompile``) / ``eval`` / ``span``
(``obs.trace``) / ``resume`` and the ``fault.*`` family (``fault.preempt``,
``fault.skip``, ``fault.spike``, ``fault.rollback``, ``fault.halt``,
``fault.poison_batch``, ``fault.fetch_retry``, ``fault.ckpt_retry``;
``training/faults.py``) / ``fit_end``.

``run_manifest.json`` pins what the run ran on: torch and CUDA versions, the
card's name and count, the process topology and a stable hash of the model
and trainer configs.

A single process writes ``events.jsonl`` (process 0 of a group alone); a
multi-process program shards, every process writing its own
``events-p{rank}.jsonl``, and :func:`merged_events` merges the shards back
into one stream. The process topology is ``torch.distributed``'s. The JAX
module's schema validator (``validate_events``) and the serving outcome
vocabulary wait for ROADMAP A6 and A11.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import heapq
import json
import os
import socket
import time
import warnings
from typing import Dict, Iterable, List, Optional

from perceiver_io_tpu_torch.parallel import dist

# bump when a row's meaning changes incompatibly; validate_events pins it
EVENT_SCHEMA_VERSION = 1


def _process_topology() -> tuple:
    """``(process_index, process_count)`` of ``torch.distributed``'s default
    group; (0, 1) when none is initialised."""
    return dist.process_index(), dist.process_count()


class EventLog:
    """Append-only JSONL event sink (``<log_dir>/events.jsonl``).

    Each :meth:`emit` opens/appends/closes — crash-safe (a killed run keeps
    every event already emitted) and cheap at the trainer's log-interval
    event rate. Non-JSON values are stringified rather than raised on: a
    telemetry write must never take the training loop down.
    """

    def __init__(
        self,
        log_dir: str,
        filename: str = "events.jsonl",
        main_process: Optional[bool] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        if process_index is None or process_count is None:
            pi, pc = _process_topology()
            process_index = pi if process_index is None else process_index
            process_count = pc if process_count is None else process_count
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if self.process_count > 1 and filename == "events.jsonl":
            # multi-process hygiene: one shard per process (every process
            # writes — the fault/span events of process 3 matter too);
            # merged_events() rebuilds the single stream
            filename = f"events-p{self.process_index}.jsonl"
            main_process = True
        elif main_process is None:
            main_process = dist.is_main_process()
        self._active = bool(main_process)
        self.log_dir = os.path.abspath(log_dir)
        self.path = os.path.join(self.log_dir, filename)
        if self._active:
            try:
                os.makedirs(self.log_dir, exist_ok=True)
            except OSError as e:
                # same contract as emit(): telemetry setup must never take
                # the training loop down (read-only/dead log filesystem)
                self._active = False
                warnings.warn(f"EventLog disabled, cannot create {self.log_dir}: {e}")

    def _row(self, event: str, fields: Dict) -> Dict:
        row = {
            "ts": round(time.time(), 6),
            "event": str(event),
            "schema_version": EVENT_SCHEMA_VERSION,
        }
        row.update(fields)
        if "span_id" not in row:
            # attribute the row to the innermost open host span (obs/trace):
            # fault.* / resume / compile events become joinable to the step
            # or request they happened in. span rows carry their own id.
            from perceiver_io_tpu_torch.obs.trace import current_span_id

            sid = current_span_id()
            if sid is not None:
                row["span_id"] = sid
        return row

    @staticmethod
    def _line(row: Dict) -> str:
        # strict JSON: NaN/Inf (a diverged loss is exactly the run this
        # log diagnoses) become null, not the invalid-JSON NaN extension
        # that breaks jq / JSON.parse consumers of events.jsonl
        try:
            return json.dumps(row, default=str, allow_nan=False)
        except ValueError:
            return json.dumps(_nan_to_none(row), default=str, allow_nan=False)

    def emit(self, event: str, **fields) -> None:
        if not self._active:
            return
        try:
            line = self._line(self._row(event, fields))
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except OSError as e:
            # the never-take-the-loop-down contract: a dead log filesystem
            # (disk full, run dir removed mid-run) deactivates the sink
            # instead of killing a long training run over telemetry
            self._active = False
            warnings.warn(f"EventLog deactivated, cannot write {self.path}: {e}")

    def emit_rows(self, event: str, rows: Iterable[Dict]) -> None:
        """Batch append: many rows of one kind through a single file open —
        the span-buffer flush path (``obs.trace.Tracer``), where per-row
        opens would tax the step loop."""
        if not self._active:
            return
        try:
            lines = [self._line(self._row(event, dict(r))) for r in rows]
            if not lines:
                return
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError as e:
            self._active = False
            warnings.warn(f"EventLog deactivated, cannot write {self.path}: {e}")

    def close(self) -> None:  # symmetry with MetricsLogger; nothing buffered
        pass


def _nan_to_none(obj):
    """Replace non-finite floats with None, recursively."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"), float("-inf")) else None
    if isinstance(obj, dict):
        return {k: _nan_to_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_nan_to_none(v) for v in obj]
    return obj


def _jsonable(obj):
    """Best-effort JSON form of a config object (dataclass / dict / repr)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return str(obj)


def config_hash(*objs) -> str:
    """Stable short hash of one or more config objects — the run identity a
    log row can be joined on (same configs, same hash, any process/host)."""
    payload = json.dumps([_jsonable(o) for o in objs], sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def write_run_manifest(
    log_dir: str,
    model_config=None,
    trainer_config=None,
    extra: Optional[Dict] = None,
    main_process: Optional[bool] = None,
    filename: str = "run_manifest.json",
) -> Dict:
    """Write ``run_manifest.json`` next to the event log; returns the
    manifest dict (on every process — only process 0 writes)."""
    import torch

    on_card = torch.cuda.is_available()
    manifest = {
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "hostname": socket.gethostname(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 0,
        "process_index": dist.process_index(),
        "process_count": dist.process_count(),
        "config_hash": config_hash(model_config, trainer_config),
        "model_config": _jsonable(model_config),
        "trainer_config": _jsonable(trainer_config),
    }
    if extra:
        manifest.update(_jsonable(extra))
    if main_process is None:
        main_process = dist.is_main_process()
    if main_process:
        try:
            os.makedirs(os.path.abspath(log_dir), exist_ok=True)
            with open(os.path.join(log_dir, filename), "w") as f:
                json.dump(manifest, f, indent=2, default=str)
        except OSError as e:
            # same contract as EventLog.emit: a telemetry write must never
            # take the training loop down
            warnings.warn(f"run manifest not written to {log_dir}: {e}")
    return manifest


# ---------------------------------------------------------------------------
# reading the stream back: shard discovery, merge, validation
# ---------------------------------------------------------------------------


def event_shards(run_dir: str) -> List[str]:
    """The event files of a run directory: ``events.jsonl`` (single-process)
    and/or ``events-p*.jsonl`` (one per process), index-sorted."""
    out = []
    single = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(single):
        out.append(single)

    def _pidx(path):
        try:
            return int(os.path.basename(path)[len("events-p") : -len(".jsonl")])
        except ValueError:
            return 1 << 30
    out.extend(sorted(glob.glob(os.path.join(run_dir, "events-p*.jsonl")), key=_pidx))
    return out


def read_event_file(path: str) -> List[Dict]:
    """Parse one shard; a torn tail line (killed run) is skipped, torn lines
    elsewhere too (the validator, not the reader, complains about those)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def merged_events(run_dir: str) -> List[Dict]:
    """One event stream for the run, whatever the process count.

    K-way merge of the shards by timestamp with a **monotonic-clock-skew
    guard**: within a shard, file order is authoritative (it is the order
    the process actually emitted in), so each row's sort key is the running
    max of its shard's timestamps — a row whose wall clock stepped backwards
    (NTP slew mid-run) cannot be sorted before its own predecessors; across
    shards, skewed clocks degrade interleaving accuracy but never reorder
    any single process's history. Ties break on (shard index, row index),
    keeping the merge deterministic."""
    streams = []
    for shard_i, path in enumerate(event_shards(run_dir)):
        rows = read_event_file(path)
        keyed = []
        ts_eff = float("-inf")
        for row_i, row in enumerate(rows):
            try:
                ts = float(row.get("ts", 0.0))
            except (TypeError, ValueError):
                ts = 0.0
            ts_eff = max(ts_eff, ts)
            keyed.append(((ts_eff, shard_i, row_i), row))
        streams.append(keyed)
    return [row for _, row in heapq.merge(*streams, key=lambda kr: kr[0])]
