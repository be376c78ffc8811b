"""Flight recorder — a bounded ring of recent telemetry, dumped on trigger
(counterpart of ``perceiver_io_tpu/obs/flightrec.py``).

``events.jsonl`` is the full history; what a p99-breach post-mortem needs is
the *recent* history frozen at the moment things went wrong, in one file,
named after the trigger. The :class:`FlightRecorder` is an event-sink
wrapper (duck-typed like ``obs.events.EventLog`` — ``emit``/``emit_rows``
pass through to the wrapped sink, so it drops into
``make_instrumented_generate_fn(events=...)`` / ``Tracer(events=...)``
unchanged): every row it forwards is also copied into a bounded in-memory
ring, the latest ``probe`` snapshot is kept aside, and a set of triggers is
checked on the way through:

- ``slo_ttft`` / ``slo_tpot`` — a ``request`` row breaching the declared
  :class:`SLOBounds` (per-request TTFT, histogram-derived TPOT p99);
- ``error`` — a ``request`` row with ``outcome="error"``;
- ``timeout`` — a ``request`` row with ``outcome="timeout"`` (a deadline
  died mid-decode or expired in the queue, ``serving.frontend``);
- ``breaker`` — a ``serve.breaker`` transition to ``open`` (the serving
  front end's circuit breaker tripped on error rate or a sentinel);
- ``blast`` — a ``probe.blast`` blast-radius report (the trainer's
  sentinel attribution, ``obs/probes.py``);
- ``sentinel`` — a ``fault.spike`` / ``fault.halt`` sentinel trip;
- ``failover`` — a ``serve.failover`` row (a fleet router's): a dead
  replica's journal replayed onto a survivor — the dump names the dead
  replica and freezes the ring around the handoff;
- ``sigusr1`` — on demand from outside (:meth:`install_signal_handler`),
  the classic "the run looks wrong, dump what you have" lever.

A trigger atomically writes ``flight-<trigger>-<n>.json`` (tmp + rename —
a scraper or a second dump never sees a torn file) into the run directory
and emits a ``flight.dump`` event naming the triggering span
(``trigger_span_id``), so the post-mortem starts from the exact request:
open the dump, find the span, read the ring backwards. Dumps are capped
(``max_dumps``) — a run breaching its SLO on every request must not turn
the run directory into a dump landfill; the cap trips once and the event
stream still records every breach.

Telemetry discipline matches ``EventLog``: a failed dump write warns and
disables nothing else — the flight recorder must never take the serving
loop down.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

FLIGHT_SCHEMA_VERSION = 1
DEFAULT_CAPACITY = 512


@dataclass
class SLOBounds:
    """Declared per-request bounds; ``None`` disables that trigger.

    ``tenants`` maps tenant name → that tenant's own bounds: a
    tenant-stamped ``request`` row is judged against ITS tenant's bounds
    (falling back to these defaults for unlisted tenants), so a relaxed
    batch tenant cannot trip the latency-sensitive tenant's trigger and
    vice versa."""

    ttft_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None
    tenants: Optional[Dict[str, "SLOBounds"]] = None

    def for_tenant(self, tenant) -> "SLOBounds":
        """The bounds governing one tenant's rows (self when the row has no
        tenant or no per-tenant override exists)."""
        if tenant is None or not self.tenants:
            return self
        return self.tenants.get(str(tenant), self)


class FlightRecorder:
    """Ring-buffering event-sink wrapper (see module docstring).

    :param events: the wrapped sink (``EventLog`` or anything with
        ``emit``; ``emit_rows`` optional). ``None`` records the ring only.
    :param out_dir: where dumps land (default: the wrapped sink's
        ``log_dir``, else the cwd).
    :param slo: :class:`SLOBounds` (mutable — a gate can tighten them for
        one planted request and restore them after).
    """

    def __init__(
        self,
        events=None,
        out_dir: Optional[str] = None,
        capacity: int = DEFAULT_CAPACITY,
        slo: Optional[SLOBounds] = None,
        max_dumps: int = 32,
    ):
        self.events = events
        self.out_dir = os.path.abspath(
            out_dir if out_dir is not None else getattr(events, "log_dir", os.getcwd())
        )
        self.slo = slo if slo is not None else SLOBounds()
        self.max_dumps = int(max_dumps)
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._probe_snapshot: Optional[Dict] = None
        self._n_dumps = 0
        # REENTRANT on purpose: the SIGUSR1 handler runs dump() on the main
        # thread and may interrupt a frame that already holds this lock
        # (_observe's ring append) — a plain Lock would deadlock the whole
        # serving process on the very lever meant for "it looks stuck"
        self._lock = threading.RLock()
        self.dumps: List[str] = []  # paths written, in order

    # -- EventLog duck-type -------------------------------------------------

    @property
    def log_dir(self) -> str:  # chained wrappers resolve the same run dir
        return getattr(self.events, "log_dir", self.out_dir)

    def emit(self, event: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(event, **fields)
        self._observe(str(event), dict(fields))

    def emit_rows(self, event: str, rows) -> None:
        rows = [dict(r) for r in rows]
        if self.events is not None:
            emit_rows = getattr(self.events, "emit_rows", None)
            if emit_rows is not None:
                emit_rows(event, rows)
            else:
                for r in rows:
                    self.events.emit(event, **r)
        # span batches don't trigger anything — they are context, not signal
        for r in rows:
            self._observe(str(event), r, check=False)

    def close(self) -> None:
        if self.events is not None and hasattr(self.events, "close"):
            self.events.close()

    # -- ring + triggers ----------------------------------------------------

    def _observe(self, event: str, fields: Dict, check: bool = True) -> None:
        row = {"ts": round(time.time(), 6), "event": event}
        row.update(fields)
        if "span_id" not in row:
            from perceiver_io_tpu_torch.obs.trace import current_span_id

            sid = current_span_id()
            if sid is not None:
                row["span_id"] = sid
        with self._lock:
            self._ring.append(row)
        if event == "probe":
            self._probe_snapshot = row
        if check:
            trigger = self._trigger_of(event, row)
            if trigger is not None:
                self.dump(trigger, row)

    def _trigger_of(self, event: str, row: Dict) -> Optional[str]:
        if event == "request":
            if row.get("outcome") == "error":
                return "error"
            if row.get("outcome") == "timeout":
                # a deadline-expired request (the front end's, mid-decode or
                # queue-expired) is an incident worth a frozen ring; a
                # "shed" or "cancelled" outcome is a policy decision, not one
                return "timeout"
            bounds = self.slo.for_tenant(row.get("tenant"))
            ttft = row.get("ttft_s")
            if (
                bounds.ttft_s is not None
                and isinstance(ttft, (int, float))
                and ttft > bounds.ttft_s
            ):
                return "slo_ttft"
            tpot99 = row.get("tpot_p99_s")
            if (
                bounds.tpot_p99_s is not None
                and isinstance(tpot99, (int, float))
                and tpot99 > bounds.tpot_p99_s
            ):
                return "slo_tpot"
        elif event == "probe.blast":
            return "blast"
        elif event in ("fault.spike", "fault.halt"):
            return "sentinel"
        elif event == "serve.breaker" and row.get("state") == "open":
            # the circuit breaker tripping IS the post-mortem moment: the
            # ring holds the error/sentinel rows that opened it
            return "breaker"
        elif event == "serve.failover":
            # a replica died and its journal was replayed onto a survivor
            # (a fleet router's): the dump names the dead
            # replica and freezes the ring around the handoff — the fleet
            # post-mortem entry point
            return "failover"
        return None

    def ring(self) -> List[Dict]:
        """A copy of the current ring contents (oldest first)."""
        with self._lock:
            return list(self._ring)

    def dump(self, trigger: str, trigger_row: Optional[Dict] = None) -> Optional[str]:
        """Write ``flight-<trigger>-<n>.json`` atomically and emit the
        ``flight.dump`` event naming the triggering span. Returns the path,
        or None when capped / the write failed."""
        with self._lock:
            if self._n_dumps >= self.max_dumps:
                return None
            self._n_dumps += 1
            n = self._n_dumps
            ring = list(self._ring)
        trigger_row = dict(trigger_row) if trigger_row else None
        payload = {
            "schema_version": FLIGHT_SCHEMA_VERSION,
            "ts": round(time.time(), 6),
            "trigger": str(trigger),
            "seq": n,
            "slo": asdict(self.slo),
            "trigger_span_id": (trigger_row or {}).get("span_id"),
            "trigger_request_id": (trigger_row or {}).get("request_id"),
            "trigger_event": trigger_row,
            "n_events": len(ring),
            "events": ring,
            "probe_snapshot": self._probe_snapshot,
        }
        path = os.path.join(self.out_dir, f"flight-{trigger}-{n}.json")
        tmp = path + ".tmp"
        try:
            # strict JSON, the events.jsonl NaN policy (non-finite -> null):
            # a dump taken DURING a numerics incident is exactly when NaNs
            # show up in the rows
            from perceiver_io_tpu_torch.obs.events import _nan_to_none

            os.makedirs(self.out_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(_nan_to_none(payload), f, indent=1, default=str, allow_nan=False)
            os.replace(tmp, path)
        except OSError as e:
            warnings.warn(f"flight recorder could not write {path}: {e}")
            return None
        with self._lock:
            # dump() runs on BOTH the serving thread (SLO-breach trigger)
            # and the signal frame (SIGUSR1): the dumps list shares the
            # ring's reentrant lock on every touch
            self.dumps.append(path)
        # through self.emit so the dump event is BOTH in the stream and in
        # the ring (the next dump shows this one happened); flight.dump is
        # not a trigger kind, so this cannot recurse
        self.emit(
            "flight.dump",
            trigger=str(trigger),
            path=path,
            seq=n,
            n_events=len(ring),
            trigger_span_id=payload["trigger_span_id"],
            trigger_request_id=payload["trigger_request_id"],
        )
        return path

    def install_signal_handler(self, signum=None):
        """Dump on SIGUSR1 (or ``signum``) — returns the previous handler so
        a caller can restore it. Main-thread only (Python signal rule)."""
        import signal as _signal

        signum = _signal.SIGUSR1 if signum is None else signum

        def _handler(sig, frame):
            self.dump("sigusr1", None)

        return _signal.signal(signum, _handler)
