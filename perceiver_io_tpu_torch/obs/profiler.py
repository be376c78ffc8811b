"""Per-scope rollup of a ``torch.profiler`` run (counterpart of the rollup in
``perceiver_io_tpu/obs/xplane.py``): where the JAX module aggregates an
xplane capture's device-op time by the ``jax.named_scope`` path in each op's
name, this module aggregates a profiler run's kernels by the
``torch.profiler.record_function`` ranges their launches were issued in, so
a trace reads by step ("decode_paged: 8.1 ms") instead of by kernel. The
public shapes are the JAX module's: :class:`ScopeRollup` (``scopes: {scope:
(ps, count)}``, ``total_ps``, ``top``), :func:`scope_of`,
:func:`rollup` / :func:`rollup_planes` and :func:`summarize`. The JAX
module's protobuf walker has no counterpart: the input is a profiler object
or its exported Chrome trace (``prof.export_chrome_trace``, JSON, optionally
gzipped).

Scopes: the port opens ranges where the JAX package opens a named scope on
the decode and train boundaries: ``prefill`` (``generation``'s prefills),
``shared_prefill``, ``decode`` (the decode pair's step), ``decode_paged``
(the engine's paged step) and ``train_step`` (``training.make_train_step``).
None opens inside a layer, and each opens (through :func:`scope`) only
while a profiler records: with none running a step pays a flag read. A
kernel belongs to the ranges open on the host thread around the runtime
call that launched it (matched by the trace's correlation id), outermost
first; a launch from a thread with no range open
(autograd's device thread runs a backward) takes the ranges open on another
thread of the process at that time (the one waiting in ``backward()``); a
kernel whose launch the trace did not record falls back to the GPU-side copy
of the ranges (``gpu_user_annotation``), then to ``<unscoped>``.

CUDA graphs: the kernels of a graph replay carry the replay's launch
(``cudaGraphLaunch``), so a captured step rolls up as its kernels under the
step's scope; the module scopes inside a step need an eager step.

Planes: one per device (``/device:GPU:<i>``: kernels, copies and memsets),
and ``/host:CPU`` for the host's operators (the outermost operator of each
nest, so nothing is counted twice), scoped the same way — on the CPU the
host plane is all there is. Each plane's per-kernel totals are kept beside
its scopes (``ScopeRollup.ops``, keyed ``scope/kernel``).
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

UNSCOPED = "<unscoped>"
HOST_PLANE = "/host:CPU"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_NO_RANGE = contextlib.nullcontext()


def scope(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a null context: the step builders' ranges enter no operator when
    nothing is profiled."""
    return record_function(name) if _autograd_profiler._is_profiler_enabled else _NO_RANGE


def scope_of(op_name: str, depth: Optional[int] = None) -> str:
    """The scope path of a rolled-up op name ``scope/.../kernel``: the final
    component (the kernel) is dropped, and ``depth`` optionally truncates to
    the leading components. Names with no scope path aggregate under
    ``<unscoped>``."""
    parts = op_name.split("/")[:-1]
    if not parts:
        return UNSCOPED
    if depth is not None:
        parts = parts[:depth]
    return "/".join(parts)


@dataclass
class PlaneSummary:
    """One plane's totals by op name (``scope/kernel``): picoseconds and
    event counts."""

    name: str
    per_op: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_ps(self) -> int:
        return sum(self.per_op.values())


@dataclass
class ScopeRollup:
    """Per-scope aggregation of one plane's events."""

    plane: str
    # scope -> (total duration ps, event count)
    scopes: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # op name (scope/kernel) -> (total duration ps, event count)
    ops: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def total_ps(self) -> int:
        return sum(d for d, _ in self.scopes.values())

    def top(self, n: int = 30) -> List[Tuple[str, int, int]]:
        rows = [(s, d, c) for s, (d, c) in self.scopes.items()]
        rows.sort(key=lambda r: -r[1])
        return rows[:n]

    def top_ops(self, n: int = 30) -> List[Tuple[str, int, int]]:
        rows = [(s, d, c) for s, (d, c) in self.ops.items()]
        rows.sort(key=lambda r: -r[1])
        return rows[:n]


def trace_document(prof) -> dict:
    """The Chrome trace of a finished ``torch.profiler`` run, as a dict. A
    run's trace can be exported once, so the first export is kept on the
    profiler and every later reader (the rollup, ``utils.profiling.trace``'s
    file) gets that copy."""
    if getattr(prof, "_rollup_trace", None) is None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            prof._rollup_trace = _read_trace(path)
    return prof._rollup_trace


def _read_trace(path) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    return doc if isinstance(doc, dict) else {"traceEvents": doc}


def _trace_events(source) -> List[dict]:
    """The Chrome trace's events of a profiler object or a trace file."""
    doc = trace_document(source) if hasattr(source, "export_chrome_trace") else _read_trace(source)
    return doc.get("traceEvents", [])


class _Ranges:
    """The record_function ranges of one thread (or one device), for
    containment queries: the ranges open at a time, outermost first."""

    def __init__(self, spans: Iterable[Tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        # ranges nest (record_function is a stack): each one's parent is the
        # innermost earlier range still open at its start
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (lo, hi, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < lo:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> List[str]:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.spans[j][1] < t:
            j = self.parent[j]
        chain = []
        while j >= 0:
            chain.append(self.spans[j][2])
            j = self.parent[j]
        return chain[::-1]


def _clean(name: str) -> str:
    return name.replace("/", "|")  # a kernel's own name never reads as a scope


def planes_of(source) -> List[PlaneSummary]:
    """Parse a profiler run (or its Chrome trace) into plane summaries: the
    device planes' kernels and the host plane's outermost operators, each
    under the scope of the ranges around it (see the module docstring)."""
    events = [e for e in _trace_events(source) if e.get("ph") == "X"]
    host_ranges: Dict[Tuple, List] = defaultdict(list)
    gpu_ranges: Dict[int, List] = defaultdict(list)
    launches: Dict[int, Tuple] = {}
    for e in events:
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            host_ranges[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, _clean(e["name"])))
        elif cat == "gpu_user_annotation":
            gpu_ranges[int((e.get("args") or {}).get("device", 0))].append((ts, ts + dur, _clean(e["name"])))
        elif cat in _RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = ((e.get("pid"), e.get("tid")), ts)
    host = {k: _Ranges(v) for k, v in host_ranges.items()}
    gpu = {k: _Ranges(v) for k, v in gpu_ranges.items()}
    planes: Dict[str, PlaneSummary] = {}

    def scope_at(thread, t: float) -> List[str]:
        chain = host[thread].at(t) if thread in host else []
        if chain:
            return chain
        # a thread with no range open (autograd's device thread launches the
        # backward) works for the thread waiting on it: the ranges open on
        # another thread of the process at that time
        for other in sorted(host, key=str):
            if other != thread and other[0] == thread[0]:
                chain = host[other].at(t)
                if chain:
                    return chain
        return []

    def add(plane: str, scope: List[str], name: str, dur_us: float) -> None:
        summary = planes.setdefault(plane, PlaneSummary(plane))
        op = "/".join(scope + [_clean(name)])
        summary.per_op[op] += int(round(dur_us * 1e6))
        summary.counts[op] += 1

    cpu_ops = defaultdict(list)
    for e in events:
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            device = int(args.get("device", 0))
            launch = launches.get(int(args["correlation"])) if args.get("correlation") is not None else None
            if launch is not None:
                scope = scope_at(*launch)
            elif device in gpu:
                scope = gpu[device].at(float(e.get("ts", 0.0)))
            else:
                scope = []
            add(f"/device:GPU:{device}", scope, e["name"], float(e.get("dur", 0.0)))
        elif cat == "cpu_op":
            cpu_ops[(e.get("pid"), e.get("tid"))].append(e)
    for thread, ops in cpu_ops.items():
        ops.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        end = -float("inf")
        for e in ops:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts < end:
                continue  # inside an outer operator, which counts its time
            end = ts + dur
            add(HOST_PLANE, scope_at(thread, ts), e["name"], dur)
    return [planes[k] for k in sorted(planes)]


def rollup_planes(planes: List[PlaneSummary], depth: Optional[int] = None) -> List[ScopeRollup]:
    """Aggregate parsed :class:`PlaneSummary` objects by scope — pure
    aggregation, no re-read of the trace."""
    out = []
    for plane in planes:
        scopes: Dict[str, List[int]] = {}
        for op, dur in plane.per_op.items():
            agg = scopes.setdefault(scope_of(op, depth=depth), [0, 0])
            agg[0] += dur
            agg[1] += plane.counts[op]
        out.append(ScopeRollup(plane=plane.name, scopes={s: (d, c) for s, (d, c) in scopes.items()},
                               ops={op: (d, plane.counts[op]) for op, d in plane.per_op.items()}))
    return out


def rollup(source, depth: Optional[int] = None) -> List[ScopeRollup]:
    """Aggregate a profiler run (a ``torch.profiler.profile`` object, or the
    path of its exported Chrome trace) by scope instead of by kernel. Each
    plane's total is the sum of its events' durations: every event lands in
    one scope bucket."""
    return rollup_planes(planes_of(source), depth=depth)


def summarize(source, top: int = 30, by_scope: bool = False, depth: Optional[int] = None,
              print_fn=print) -> List[PlaneSummary]:
    """Print per-plane totals (per-op, or per-scope with ``by_scope``) and
    return the plane summaries."""
    planes = planes_of(source)
    scoped = rollup_planes(planes, depth=depth) if by_scope else None
    for i, plane in enumerate(planes):
        print_fn(f"\n=== plane: {plane.name}")
        print_fn(f"    sum of event time: {plane.total_ps / 1e9:.3f} ms")
        if by_scope:
            for s, d, c in scoped[i].top(top):
                print_fn(f"  {d / 1e9:9.3f} ms {c:6d}x  {s[:100]}")
        else:
            for op, d in sorted(plane.per_op.items(), key=lambda kv: -kv[1])[:top]:
                print_fn(f"  {d / 1e9:9.3f} ms {plane.counts[op]:6d}x  {op[:100]}")
    return planes
