"""Metrics registry: counters, gauges and log-bucketed latency histograms
(a copy of ``perceiver_io_tpu/obs/metrics.py``, which imports only the
standard library; ``Histogram.record`` takes a ``count``).

The substrate the serving road publishes into (ROADMAP item 1: the
continuous-batching scheduler's queue depth, admission rate and per-request
latencies all land here): record paths are a dict update under a lock —
cheap enough for per-token calls — and the registry exports three ways:

- ``snapshot()`` — plain JSON dict (what lands in a ``metrics`` event row;
  ``maybe_emit`` rate-limits the rows so per-request callers can snapshot
  opportunistically without flooding events.jsonl);
- ``to_prometheus()`` — Prometheus text exposition (counters, gauges, and
  cumulative ``_bucket{le=...}`` histogram series) for scrape endpoints;
- per-histogram ``percentile()`` — p50/p99 **from the buckets**, not means.

Every metric type supports **labels** (Simline, docs/observability.md#
labeled-metrics): ``metric.labels(tenant="a")`` returns a get-or-create
child of the same type that records independently and exposes as
``name{tenant="a"}`` series under the parent's family (one ``# TYPE`` line;
label sets render key-sorted). The parent stays the unlabeled series — the
serving counters increment BOTH (parent = the all-tenant total), so
dashboards built on the unlabeled names keep working and the exposition of
a label-free registry is byte-identical to the pre-label format.

Histograms are log-bucketed: bucket ``i`` covers ``[GROWTH**i, GROWTH**(i+1))``
with ``GROWTH = 2**0.25`` (~19% wide), so a reported percentile is the bucket's
geometric midpoint — within ~9% of the true order statistic at any scale from
microseconds to minutes, with O(1) record cost and a sparse dict of counts
that merges exactly across histograms (the property ``obs/slo.py`` uses to
aggregate per-request TPOT histograms into run percentiles).
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, Optional

# bucket width factor: 2**0.25 per bucket — 4 buckets per octave, ~9% max
# midpoint error; shared by every histogram so counts merge exactly
GROWTH = 2.0**0.25
_LOG_GROWTH = math.log(GROWTH)
# values at or below this clamp into the bottom bucket (zero/negative
# latencies are clock-resolution artifacts, not data)
_MIN_VALUE = 1e-9
_MIN_INDEX = int(math.floor(math.log(_MIN_VALUE) / _LOG_GROWTH))


def bucket_index(value: float) -> int:
    """The log-bucket index of a positive value (clamped at the bottom)."""
    v = float(value)
    if not v > _MIN_VALUE:
        return _MIN_INDEX
    return max(int(math.floor(math.log(v) / _LOG_GROWTH)), _MIN_INDEX)


def bucket_bounds(index: int) -> tuple:
    return (GROWTH**index, GROWTH ** (index + 1))


def bucket_mid(index: int) -> float:
    """Geometric midpoint — the representative value of one bucket."""
    return GROWTH ** (index + 0.5)


def percentile_from_counts(counts: Dict[int, int], p: float) -> Optional[float]:
    """Nearest-rank percentile over sparse ``{bucket_index: count}`` —
    returns the hit bucket's geometric midpoint, or None when empty.
    ``counts`` may be the merge of many histograms (bucket bounds are
    global), which is exactly how run-level SLO percentiles are built."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile p must be in [0, 100], got {p}")
    total = sum(counts.values())
    if total == 0:
        return None
    target = max(int(math.ceil(p / 100.0 * total)), 1)
    seen = 0
    for idx in sorted(counts):
        seen += counts[idx]
        if seen >= target:
            return bucket_mid(idx)
    return bucket_mid(max(counts))  # unreachable; defensive


def merge_counts(*count_dicts: Dict) -> Dict[int, int]:
    """Sum sparse bucket-count dicts (string keys from JSON round-trips are
    accepted)."""
    out: Dict[int, int] = {}
    for d in count_dicts:
        for k, v in (d or {}).items():
            out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def _label_key(labels: Dict[str, str]) -> tuple:
    """Canonical child identity: the key-sorted ``(name, value)`` tuple."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(key: tuple) -> str:
    """``tenant="a",zone="b"`` — the rendered (key-sorted) label set."""
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)


class _LabelSupport:
    """Shared ``labels()`` machinery: get-or-create a CHILD metric of the
    parent's type, keyed by the sorted label set. Children record
    independently of the parent (callers that want the unlabeled series to
    stay the all-label total write both — the serving counters do); they
    expose under the parent's family as ``name{k="v"}`` series and never
    have children of their own."""

    def labels(self, **labels):
        if not labels:
            raise ValueError("labels() needs at least one label")
        if self.label_set:
            raise ValueError(
                f"metric {self.name!r} is already a labeled child "
                f"{{{_label_str(self.label_set)}}}; labels() nests one level"
            )
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help)
                child.label_set = key
                self._children[key] = child
            return child

    def children(self):
        """``(label_key, child)`` pairs, label-sorted (a locked copy)."""
        with self._lock:
            return sorted(self._children.items())


class Counter(_LabelSupport):
    """Monotonic counter. ``inc`` is the only mutation."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._children: Dict[tuple, Counter] = {}
        self.label_set: tuple = ()
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_LabelSupport):
    """Last-write-wins scalar (queue depth, inflight requests, ...).

    :attr:`peak` keeps the high-water mark across every write — the
    "what did it reach" question a scrape-cadence consumer cannot answer
    from :attr:`value` alone (a depth spike between scrapes is invisible).
    The engine's ``serve_parked_depth`` gauge reads it into the LOAD
    artifact's ``parked_depth_peak``; ``None`` until the first write."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._peak = None
        self._children: Dict[tuple, Gauge] = {}
        self.label_set: tuple = ()
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._peak = self._value if self._peak is None else max(self._peak, self._value)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += float(n)
            self._peak = self._value if self._peak is None else max(self._peak, self._value)

    @property
    def value(self) -> float:
        return self._value

    @property
    def peak(self):
        """High-water mark over every write (None before the first)."""
        return self._peak

    def reset_peak(self) -> None:
        """Restart the high-water mark at the CURRENT value — the
        measured-window boundary seam (tools/loadgen.py resets after its
        warmup leg so the committed peak covers only the measured run).
        A gauge never written stays peak-less. Resets labeled children too
        (the window boundary applies to the whole family)."""
        with self._lock:
            self._peak = None if self._peak is None else self._value
            children = list(self._children.values())
        for child in children:
            child.reset_peak()


class Histogram(_LabelSupport):
    """Log-bucketed distribution (see module docstring). Standalone-usable:
    the instrumented generate fn keeps one per request for the TPOT
    percentiles its ``request`` event carries."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._children: Dict[tuple, Histogram] = {}
        self.label_set: tuple = ()
        self._lock = threading.Lock()

    def record(self, value: float, count: int = 1) -> None:
        """Record ``value``, ``count`` times (the port's addition: the
        serving engine records one step time for every slot of a step in one
        update)."""
        v = float(value)
        idx = bucket_index(v)
        with self._lock:
            self.counts[idx] = self.counts.get(idx, 0) + count
            self.n += count
            self.sum += v * count
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def state(self) -> tuple:
        """Consistent ``(counts copy, n, sum, min, max)`` under the lock —
        the read side for exporters living on OTHER threads (a scrape
        server iterating ``counts`` while the serving thread records would
        see a dict mutating under it)."""
        with self._lock:
            return dict(self.counts), self.n, self.sum, self.min, self.max

    def reset(self) -> None:
        """Drop every recorded sample — the warmup seam: a drive that warms
        compile caches through the SAME instance it then measures resets
        the latency histograms at the measured-window boundary, so committed
        percentiles cover only measured traffic. Exposition scrapes handle
        the count going backwards the way Prometheus clients handle any
        counter reset; call it between windows, not mid-scrape-storm.
        Resets labeled children too (the window covers the family)."""
        with self._lock:
            self.counts = {}
            self.n = 0
            self.sum = 0.0
            self.min = None
            self.max = None
            children = list(self._children.values())
        for child in children:
            child.reset()

    def percentile(self, p: float) -> Optional[float]:
        """Bucket-midpoint percentile, clamped into the observed [min, max]
        (a one-sample histogram reports the sample, not its bucket's
        midpoint)."""
        counts, _, _, mn, mx = self.state()
        out = percentile_from_counts(counts, p)
        if out is None:
            return None
        if mn is not None:
            out = min(max(out, mn), mx)
        return out

    def to_dict(self) -> Dict:
        counts, n, total, mn, mx = self.state()
        d = {
            "n": n,
            "sum": round(total, 9),
            "min": mn,
            "max": mx,
            "counts": {str(k): v for k, v in sorted(counts.items())},
        }
        if n:
            for p in (50, 90, 99):
                out = percentile_from_counts(counts, p)
                if mn is not None:
                    out = min(max(out, mn), mx)
                d[f"p{p}"] = out
            if n < 5:
                # the low-sample convention shared with StepTimer.summary:
                # a 3-sample p99 is an order statistic, not a tail estimate
                d["low_n"] = True
        return d


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class MetricsRegistry:
    """Get-or-create registry of named metrics; the name is the identity
    (asking twice returns the same object, asking with a different type
    raises).

    ``clock`` drives the :meth:`maybe_emit` rate limit. The front ends
    pass their own injected clock when they construct the default
    registry, so a ``ManualClock`` chaos/sim run rate-limits in virtual
    time instead of silently reading the wall."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._last_emit = 0.0

    def _get(self, name: str, cls, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(name, Histogram, help)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> Dict:
        """JSON-ready state of every metric — the ``metrics`` event body.
        Labeled children ride as additional entries keyed by the rendered
        series name (``serve_submitted{tenant="a"}``), so a ``metrics``
        event row carries per-tenant series with zero schema change."""
        out: Dict = {"counters": {}, "gauges": {}, "histograms": {}, "gauge_peaks": {}}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            for key, metric in [((), m)] + m.children():
                sname = f"{name}{{{_label_str(key)}}}" if key else name
                if isinstance(m, Counter):
                    out["counters"][sname] = metric.value
                elif isinstance(m, Gauge):
                    out["gauges"][sname] = metric.value
                    # the high-water mark rides along: a depth spike between
                    # snapshots is invisible in `value`, and a post-hoc
                    # consumer (obs_report's per-tenant table) cannot reach
                    # the in-process Gauge.peak
                    if metric.peak is not None:
                        out["gauge_peaks"][sname] = metric.peak
                elif isinstance(m, Histogram):
                    out["histograms"][sname] = metric.to_dict()
        return out

    def emit_snapshot(self, events) -> None:
        """One ``metrics`` event row with the full snapshot."""
        events.emit("metrics", **self.snapshot())
        self._last_emit = self._clock()

    def maybe_emit(self, events, min_interval_s: float = 30.0) -> bool:
        """Rate-limited :meth:`emit_snapshot` — call it opportunistically
        from hot-ish paths (per request, per log window); at most one row
        per ``min_interval_s``. Returns True when a row was written."""
        if events is None or not self._metrics:
            return False
        now = self._clock()
        if now - self._last_emit < min_interval_s:
            return False
        self.emit_snapshot(events)
        return True

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the registry (counters/gauges as-is,
        histograms as cumulative ``_bucket{le="..."}`` series + _sum/_count).
        Labeled children render inside the parent's family — one ``# TYPE``
        line, the unlabeled series first, then each child's series with its
        key-sorted label set — so a label-free registry's exposition is
        byte-identical to the pre-label format."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
            for key, metric in [((), m)] + m.children():
                ls = _label_str(key)
                if isinstance(m, (Counter, Gauge)):
                    series = f"{pname}{{{ls}}}" if ls else pname
                    lines.append(f"{series} {metric.value:g}")
                    continue
                # consistent locked snapshot: a scrape thread must never
                # iterate counts while the serving thread inserts a bucket
                # (dict-changed-size), nor expose cumulative > _count
                counts, n, total, _, _ = metric.state()
                prefix = f"{ls}," if ls else ""
                suffix = f"{{{ls}}}" if ls else ""
                cum = 0
                for idx in sorted(counts):
                    cum += counts[idx]
                    le = bucket_bounds(idx)[1]
                    lines.append(f'{pname}_bucket{{{prefix}le="{le:g}"}} {cum}')
                lines.append(f'{pname}_bucket{{{prefix}le="+Inf"}} {n}')
                lines.append(f"{pname}_sum{suffix} {total:g}")
                lines.append(f"{pname}_count{suffix} {n}")
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (callers that want isolation construct
    their own — the instrumented generate fn does)."""
    return _DEFAULT
