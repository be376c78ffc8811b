"""Host spans (counterpart of ``perceiver_io_tpu/obs/trace.py``: ``Span``,
``Tracer``, ``maybe_span``, ``current_span_id``, ``host_device_breakdown``).

A :class:`Span` is a host wall-clock interval with an id, a parent, a name and
attrs, persisted as a ``span`` row in ``events.jsonl``; while a span is open
it is the *current* span, and ``obs.events.EventLog.emit`` stamps its id onto
every row emitted inside it, so ``fault.*`` / ``resume`` / ``compile``
events are attributable to the step they happened in. The trainer opens
``fit``, ``step``, ``eval``, ``checkpoint`` and ``resume`` spans.

Two scoping mechanisms compose: a contextvar stack (per thread), and an
ambient fallback (process-global) that the trainer's ``fit`` span publishes,
so events emitted from other threads (the prefetch producer's
``fault.poison_batch``) still land inside it. Span rows are buffered in the
:class:`Tracer` and flushed in batches at log boundaries and fit exits.

:func:`host_device_breakdown` joins a run's step spans to the device side
of a ``torch.profiler`` capture rolled up by ``obs.profiler.rollup``.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perceiver_io_tpu_torch.parallel import dist

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "obs_current_span", default=None
)
_AMBIENT: List["Span"] = []
_AMBIENT_LOCK = threading.Lock()


def new_span_id() -> str:
    """16-hex random span id (collision-safe per run, short enough to read)."""
    return os.urandom(8).hex()


@dataclass
class Span:
    """One host wall-clock interval. ``t_start``/``t_end`` are epoch seconds
    (the ``ts`` convention of events.jsonl); the duration is measured on
    ``perf_counter`` so it cannot be NTP-stepped mid-span."""

    name: str
    span_id: str = field(default_factory=new_span_id)
    parent_id: Optional[str] = None
    t_start: float = field(default_factory=time.time)
    t_end: Optional[float] = None
    process_index: int = field(default_factory=dist.process_index)
    attrs: Dict = field(default_factory=dict)
    _perf0: float = field(default_factory=time.perf_counter, repr=False)
    _dur_s: Optional[float] = field(default=None, repr=False)

    def set(self, key: str, value) -> None:
        """Attach/overwrite one attr (shows up under ``attrs`` in the row)."""
        self.attrs[str(key)] = value

    def close(self) -> None:
        if self._dur_s is None:
            self._dur_s = time.perf_counter() - self._perf0
            self.t_end = self.t_start + self._dur_s

    @property
    def dur_ms(self) -> float:
        return 1e3 * (self._dur_s if self._dur_s is not None else time.perf_counter() - self._perf0)

    def to_row(self) -> Dict:
        """The ``span`` event row (sans ``ts``/``schema_version`` — the
        EventLog stamps those)."""
        self.close()
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": round(self.t_start, 6),
            "t_end": round(self.t_end, 6),
            "dur_ms": round(self.dur_ms, 3),
            "process_index": self.process_index,
            "attrs": dict(self.attrs),
        }


def current_span() -> Optional[Span]:
    """The innermost open span of this thread/task, falling back to the
    process-ambient span (the trainer's ``fit``) for foreign threads."""
    s = _CURRENT.get()
    if s is not None:
        return s
    with _AMBIENT_LOCK:
        return _AMBIENT[-1] if _AMBIENT else None


def current_span_id() -> Optional[str]:
    s = current_span()
    return None if s is None else s.span_id


class Tracer:
    """Span factory bound to one event sink (``obs.events.EventLog`` or
    anything with ``emit_rows``/``emit``); rows are buffered and flushed in
    batches. ``events=None`` keeps the span context live (ids still stamp
    onto other sinks' rows) but records nothing."""

    def __init__(self, events=None, flush_every: int = 256):
        self.events = events
        self.flush_every = max(int(flush_every), 1)
        self._rows: List[Dict] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, ambient: bool = False, **attrs):
        """Open a span; yields it so the body can ``.set(...)`` attrs.
        ``ambient=True`` additionally publishes it as the process-wide
        fallback for the duration (see module docstring)."""
        s = Span(name=str(name), parent_id=current_span_id(), attrs=dict(attrs))
        token = _CURRENT.set(s)
        if ambient:
            with _AMBIENT_LOCK:
                _AMBIENT.append(s)
        try:
            yield s
        finally:
            _CURRENT.reset(token)
            if ambient:
                with _AMBIENT_LOCK:
                    if s in _AMBIENT:
                        _AMBIENT.remove(s)
            self.record(s)

    def start(self, name: str, **attrs) -> Span:
        """Non-context form (pair with :meth:`end`) for open/close sites
        that straddle a loop iteration — the trainer's per-step span closes
        at the NEXT iteration's top, which no ``with`` block can express."""
        s = Span(name=str(name), parent_id=current_span_id(), attrs=dict(attrs))
        s._cv_token = _CURRENT.set(s)
        return s

    def end(self, span: Span) -> None:
        token = getattr(span, "_cv_token", None)
        if token is not None:
            try:
                _CURRENT.reset(token)
            except ValueError:  # closed from a foreign context; defensive
                pass
            span._cv_token = None
        self.record(span)

    def record(self, span: Span) -> None:
        span.close()
        with self._lock:
            self._rows.append(span.to_row())
            full = len(self._rows) >= self.flush_every
        if full:
            self.flush()

    def flush(self) -> None:
        """Write all buffered span rows in one batch (no-op when empty or
        sink-less)."""
        with self._lock:
            rows, self._rows = self._rows, []
        if not rows or self.events is None:
            return
        emit_rows = getattr(self.events, "emit_rows", None)
        if emit_rows is not None:
            emit_rows("span", rows)
        else:  # duck-typed sink without the batch API
            for r in rows:
                self.events.emit("span", **r)


def maybe_span(tracer: Optional[Tracer], name: str, **attrs):
    """``tracer.span(name, ...)`` — or a null context yielding None when
    tracing is off, so call sites stay one-liners."""
    if tracer is None:
        return contextlib.nullcontext(None)
    return tracer.span(name, **attrs)


# ---------------------------------------------------------------------------
# host/device correlation: join step spans to profiler scope rollups
# ---------------------------------------------------------------------------


def host_device_breakdown(span_rows, rollups=None, step_name: str = "step", top_scopes: int = 8) -> Dict:
    """The per-step host/device breakdown (the JAX function's shape).

    ``span_rows`` are ``span`` event rows (dicts); ``rollups`` is the output
    of ``obs.profiler.rollup``/``rollup_planes`` over a capture taken during
    the same run (None → host-only breakdown). Host side: per-step span
    duration percentiles plus the mean ``input_wait_ms``/``dispatch_ms``
    attrs the trainer stamps; ``checkpoint``/``eval`` spans aggregate
    separately. Device side: total device-plane time divided by the step
    count (the "compute" column host timing cannot see — the step loop never
    blocks on the card), plus the top scopes; without a device plane (a CPU
    capture) the host plane stands in.
    """
    from perceiver_io_tpu_torch.utils.profiling import summarize_latencies

    spans = [r for r in span_rows if r.get("event", "span") == "span"]
    steps = [r for r in spans if r.get("name") == step_name]
    out: Dict = {"steps": len(steps)}
    if steps:
        out["step_ms"] = summarize_latencies([float(r["dur_ms"]) for r in steps])
        for attr in ("input_wait_ms", "dispatch_ms"):
            vals = [
                float(r["attrs"][attr])
                for r in steps
                if isinstance(r.get("attrs"), dict) and attr in r["attrs"]
            ]
            if vals:
                out[attr] = sum(vals) / len(vals)
    for phase in ("checkpoint", "eval"):
        rows = [r for r in spans if r.get("name") == phase]
        if rows:
            out[phase] = {
                "count": len(rows),
                "total_ms": round(sum(float(r["dur_ms"]) for r in rows), 3),
            }
    if rollups:
        device = [r for r in rollups if "device" in getattr(r, "plane", "").lower()] or list(rollups)
        total_ps = sum(r.total_ps for r in device)
        scope_totals: Dict[str, int] = {}
        for r in device:
            for scope, (dur, _count) in r.scopes.items():
                scope_totals[scope] = scope_totals.get(scope, 0) + dur
        top = sorted(scope_totals.items(), key=lambda kv: -kv[1])[:top_scopes]
        out["device"] = {
            "total_ms": round(total_ps / 1e9, 9),
            "per_step_ms": round(total_ps / 1e9 / max(len(steps), 1), 9) if steps else None,
            "top_scopes": [{"scope": s, "ms": round(d / 1e9, 9)} for s, d in top],
        }
    return out
