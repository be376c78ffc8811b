"""Recapture tracking (counterpart of ``perceiver_io_tpu/obs/recompile.py``).

The JAX package watches a jitted step's executable cache: a call that grew it
compiled. The port's compile is a CUDA graph capture: a ``graphs.CapturedStep``
captures at its first call and again when the batch's keys, shapes or dtypes
change, or when it is handed other objects; a decode step
(``generation._GraphedStep``) captures once, at its first call.
:class:`RecompileTracker` wraps a step whose ``captured`` attribute is such an
object (``make_train_step``'s and ``make_eval_step``'s functions,
``make_decode_fns``' and ``make_paged_step_fn``'s steps), or which is one
itself (``make_speculative_paged_step_fn``'s step on the card), reads its ``captures`` count around each call, and books
each new capture's host seconds: a ``compile`` event and the goodput
``compile`` bucket. So a ``compiled`` flag of the serving path means "this
call captured". A step that runs eagerly (on the CPU) never captures and
books nothing.

The first capture is expected; any later ``compile`` event on the same step
is a batch whose shape moved.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

from torch.utils._pytree import tree_leaves


def shape_signature(args, kwargs=None, top: int = 8) -> Dict:
    """Compact signature of a call's array arguments: leaf count and the most common ``dtype[shape]`` strings,
    enough to diff two ``compile`` events and see which input changed."""
    leaves = [x for x in tree_leaves((args, kwargs or {})) if x is not None]
    counter = collections.Counter()
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is None:
            counter[type(leaf).__name__] += 1
        else:
            dtype = getattr(leaf, "dtype", None)
            counter[f"{str(dtype).replace('torch.', '')}{list(shape)}"] += 1
    return {"leaves": len(leaves), "shapes": dict(counter.most_common(top))}


class RecompileTracker:
    """Wrap captured steps; count and log their captures.

    ``events`` (an ``obs.events.EventLog``) and ``goodput`` (an
    ``obs.mfu.GoodputTracker``) are plain attributes so a long-lived tracker
    (the Trainer wraps its steps once at construction) can be pointed at
    each ``fit()``'s sinks.
    """

    def __init__(self, events=None, goodput=None):
        self.events = events
        self.goodput = goodput
        self._state: Dict[str, Dict] = {}

    def wrap(self, fn: Callable, name: str) -> Callable:
        st = self._state.setdefault(name, {"calls": 0, "compiles": 0, "compile_s": 0.0})
        captured = getattr(fn, "captured", None)
        if captured is None and hasattr(fn, "captures"):
            captured = fn

        def wrapped(*args, **kwargs):
            before = 0 if captured is None else captured.captures
            out = fn(*args, **kwargs)
            st["calls"] += 1
            for dt in [] if captured is None else captured.capture_s[before:]:
                st["compiles"] += 1
                st["compile_s"] += dt
                if self.goodput is not None:
                    self.goodput.add("compile", dt)
                if self.events is not None:
                    self.events.emit(
                        "compile",
                        fn=name,
                        wall_s=round(dt, 6),
                        n_compiles=st["compiles"],
                        captures=captured.captures,
                        arg_shapes=shape_signature(args, kwargs),
                    )
            return out

        wrapped.__name__ = f"tracked_{name}"
        wrapped.__wrapped__ = fn
        wrapped.captured = captured
        return wrapped

    def counts(self) -> Dict[str, int]:
        return {name: st["compiles"] for name, st in self._state.items()}

    @property
    def total_compiles(self) -> int:
        return sum(st["compiles"] for st in self._state.values())

    @property
    def total_compile_s(self) -> float:
        return sum(st["compile_s"] for st in self._state.values())
