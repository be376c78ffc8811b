"""CUDA graphs for the port's step functions: the counterpart of the JAX
package's ``jax.jit`` steps (the paged decode step, the train step and the
eval step).

A step is captured on the card into one ``torch.cuda.CUDAGraph`` and replayed
from then on, so the host launches one graph where it dispatched every
operation. A graph reads and writes fixed addresses: the step's state and
static input buffers that the caller fills before each replay.

- :func:`warm_up` runs a step once, eagerly, on the side stream the capture
  will use. That first run loads the kernels' libraries, compiles the Triton
  kernels, caches K3's launch plan, lets cuBLAS and the optimizer create
  their state and activation offloading allocate its pinned host buffers
  (``core.remat``), none of which may happen inside a capture. It is a real step:
  its result is the caller's, and its launches are counted.
- :class:`Graph` captures a warmed-up step. A capture runs no kernel, so the
  launches the wrappers count while it records are taken back out of
  ``ops.build.LAUNCHES`` (and ``LAUNCHES_BY_KV``) and kept as the graph's
  count a replay; :meth:`Graph.replay` adds them again. ``LAUNCHES`` stays
  the count of kernels the card ran.
- :class:`CapturedStep` does both for a step whose inputs arrive as a batch
  dict (the train and eval steps): it captures at the first call and again
  when the batch's keys, shapes or dtypes change (as ``jit`` retraces), and
  copies each call's batch into the capture's static buffers before a replay.
  It counts its captures and their host seconds (``obs.recompile`` reads
  them, as the JAX package's tracker reads ``jit``'s cache size).

A capture that fails raises; no caller falls back to the eager step.
"""

from __future__ import annotations

import gc
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_map_only

from perceiver_io_tpu_torch.ops import build


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` warms up and records on,
    one a device: torch keeps a cuBLAS workspace for each stream it runs a
    GEMM on and never frees it (65 MiB on an H100), so a new stream for each
    capture would keep that much with every captured step that is dropped."""
    device = torch.device(device)
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def warm_up(fn: Callable[[], Any], stream: "torch.cuda.Stream") -> Any:
    """Run ``fn()`` once on ``stream`` (ordered after the current stream's
    work, and before the current stream's next) and return its result."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


class Graph:
    """``fn()`` captured on ``stream`` into one CUDA graph; ``outputs`` are
    the tensors it returned, rewritten by every :meth:`replay`.

    CUDA generators that ``fn`` draws from are registered with the graph, so
    each replay draws fresh numbers (the default generator always is). The
    captured graph is kept beside its executable for :meth:`kernel_nodes`.

    Python's automatic garbage collection is off while the capture records:
    a collection could free a dropped graph held in a reference cycle, and
    destroying a CUDA graph is refused while a stream captures, which ends
    the capture with an error. The capture is thread-local, so the threads a
    trainer runs beside it (the batch prefetch, the checkpoint writer) may
    call into CUDA meanwhile."""

    def __init__(self, fn: Callable[[], Any], name: str, stream: "torch.cuda.Stream",
                 generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in generators:
            self.graph.register_generator_state(generator)
        before, before_kv = dict(build.LAUNCHES), dict(build.LAUNCHES_BY_KV)
        failure = []

        def body():
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 -- kept to name it when ending the capture raises too
                failure.append(e)
                raise

        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                self.outputs = body()
        except RuntimeError as e:
            first = failure[0] if failure else e
            hint = ("; the backward's gradient accumulators were made on another stream: drop every "
                    "reference to an eager forward's autograd graph over these parameters (its loss, its "
                    "metrics) before the first call") if "legacy stream" in str(first) else ""
            raise RuntimeError(f"capturing {name} into a CUDA graph failed: {first}{hint}") from first
        finally:
            if collecting:
                gc.enable()
            self.launches = {k: n - before[k] for k, n in build.LAUNCHES.items() if n != before[k]}
            build.LAUNCHES.update(before)
            self.launches_by_kv = {k: n - before_kv.get(k, 0) for k, n in build.LAUNCHES_BY_KV.items()
                                   if n != before_kv.get(k, 0)}
            build.LAUNCHES_BY_KV.clear()
            build.LAUNCHES_BY_KV.update(before_kv)
        self.graph.instantiate()

    def replay(self) -> Any:
        self.graph.replay()
        for name, n in self.launches.items():
            build.LAUNCHES[name] += n
        for key, n in self.launches_by_kv.items():
            build.LAUNCHES_BY_KV[key] = build.LAUNCHES_BY_KV.get(key, 0) + n
        return self.outputs

    def kernel_nodes(self, names: Sequence[str]) -> Dict[str, int]:
        """How many kernel nodes of the captured graph run each named kernel
        (a node whose function's name, mangled or not, holds the name not
        preceded by a letter or underscore), from the graph's DOT dump;
        ``"kernel nodes"`` counts them all."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.dot")
            self.graph.debug_dump(path)
            with open(path) as f:
                return count_kernel_nodes(f.read(), names)


def count_kernel_nodes(dot: str, names: Sequence[str]) -> Dict[str, int]:
    """Kernel nodes by name in a CUDA graph's DOT dump (see
    :meth:`Graph.kernel_nodes`)."""
    nodes = re.findall(r'^\s*"[^"]+"\s*\[(.*?)\];\s*$', dot, flags=re.M | re.S)
    kernels = [n for n in nodes if "KERNEL" in n]
    counts = {"kernel nodes": len(kernels)}
    for name in names:
        ident = re.compile(r"(?<![A-Za-z_])" + re.escape(name))  # mangled: length digits before, 'I'/'E' after
        counts[name] = sum(1 for n in kernels if ident.search(n))
    return counts


def _as_tensor(value) -> Optional[torch.Tensor]:
    return None if value is None else torch.as_tensor(value)


def batch_signature(batch: Dict[str, Any]) -> tuple:
    """What a capture depends on in a batch: its keys, and each value's
    shape and dtype (or None)."""
    out = []
    for key in sorted(batch):
        t = _as_tensor(batch[key])
        out.append((key, None) if t is None else (key, tuple(t.shape), t.dtype))
    return tuple(out)


class CapturedStep:
    """``fn(*bound, batch)`` captured per batch signature on the card.

    ``bound`` are the objects the step works on (a model, a train state's
    parts); a call with other objects, or with a batch of another
    signature, captures anew (the old graph and its memory are dropped
    first). The first call of each capture is the warm-up and returns its
    own result; later calls copy the batch into the capture's device
    buffers and replay. Results are copies of the graph's outputs, so a
    caller may keep them across calls. ``captures`` counts the captures made
    and ``capture_s`` holds each capturing call's host seconds (the warm-up
    step's dispatch, the capture and the instantiation)."""

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name
        self.graph: Optional[Graph] = None
        self.captures = 0
        self.capture_s: List[float] = []
        self._bound: tuple = ()
        self._key = None
        self._static: Dict[str, Optional[torch.Tensor]] = {}

    def __call__(self, *bound, batch: Dict[str, Any], device: torch.device,
                 generators: Iterable[torch.Generator] = ()) -> Any:
        key = batch_signature(batch)
        same = len(bound) == len(self._bound) and all(a is b for a, b in zip(bound, self._bound))
        if self.graph is not None and same and key == self._key:
            self._fill(batch)
            return tree_map_only(torch.Tensor, torch.Tensor.clone, self.graph.replay())
        t0 = time.perf_counter()
        self.graph = None
        self._static = {k: None if t is None else torch.empty(t.shape, dtype=t.dtype, device=device)
                        for k, t in ((k, _as_tensor(v)) for k, v in batch.items())}
        self._fill(batch)
        stream = capture_stream(device)
        out = warm_up(lambda: self.fn(*bound, self._static), stream)
        self.graph = Graph(lambda: self.fn(*bound, self._static), self.name, stream, generators)
        self._bound, self._key = bound, key
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
        return out

    def _fill(self, batch: Dict[str, Any]) -> None:
        for k, buf in self._static.items():
            if buf is not None:
                buf.copy_(torch.as_tensor(batch[k]), non_blocking=True)
