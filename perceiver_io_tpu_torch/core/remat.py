"""Per-layer activation checkpointing and offloading (counterpart of
``perceiver_io_tpu/core/modules.py::_remat``).

A layer built with ``activation_checkpointing`` runs its body under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
only the body's inputs, and the backward recomputes the body (its LayerNorms,
projections and attention kernels launch again) before it differentiates it.
The JAX package's ``nn.remat`` does the same.

``activation_offloading`` is the JAX package's
``offload_dot_with_no_batch_dims("device", "pinned_host")`` policy: the
outputs of the dots without batch dims are kept in pinned host memory and
everything else is recomputed. In the port those dots are exactly the
projections of :func:`core.attention.dense`, so the seam is there: inside an
offloaded body ``dense`` copies its output to a pinned host buffer in the
forward, and in the recompute hands that copy back instead of multiplying
again. Its backward is the one ``F.linear`` has (the same two products and
the bias sum), so the gradients equal those of the layer without offloading.
On the CPU the host is the device: the output is kept where it lies.

The recompute draws no random numbers: a layer draws its dropout masks before
its body (``core.dropout``), so the body is checkpointed with
``preserve_rng_state=False``. It runs under the forward's kernel features
(``ops.flash_attention.fast_kernels``): on the card the backward, and so the
recompute, runs on autograd's device thread, which does not see the
forward's context, and a recompute on another route would recompute other
tensors.

The pinned buffers belong to an :class:`OffloadArena` of the module that owns
the layers (``PerceiverAR``, ``PerceiverEncoder``, ``PerceiverDecoder``), taken
in call order and reused by the next forward of that module, so a captured
train step replays into the same host addresses. They are allocated by the
first forward that needs them; a CUDA graph capture cannot allocate them, so
a capture follows an eager warm-up step (``graphs.warm_up``). A forward's
offloaded outputs live until the owner's next forward: run its backward
before then.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perceiver_io_tpu_torch.obs import probes
from perceiver_io_tpu_torch.ops.flash_attention import fast_features, fast_kernels

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("offload", default=None)


def remat_mode(activation_checkpointing: bool, activation_offloading: bool) -> Optional[str]:
    """The layers' mode from the two config flags: offloading implies
    recomputation (the JAX package's ``_remat`` takes the offload policy
    whenever ``activation_offloading`` is set)."""
    if activation_offloading:
        return "offload"
    return "checkpoint" if activation_checkpointing else None


class OffloadArena:
    """Pinned host buffers for one forward's offloaded projection outputs,
    taken in order and reused by every later forward (see the module
    docstring)."""

    def __init__(self):
        self.buffers: List[torch.Tensor] = []
        self.next = 0

    def reset(self) -> None:
        self.next = 0

    def take(self, like: torch.Tensor) -> torch.Tensor:
        i = self.next
        self.next += 1
        if i < len(self.buffers) and self.buffers[i].shape == like.shape and self.buffers[i].dtype == like.dtype:
            return self.buffers[i]
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "activation offloading: a CUDA graph capture cannot allocate pinned host memory; run the step "
                "eagerly once first (make_train_step's first call does) so that every offload buffer exists")
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        if i < len(self.buffers):
            self.buffers[i] = buf
        else:
            self.buffers.append(buf)
        return buf


class _Dense(torch.autograd.Function):
    """``F.linear(x, w, b)``, or in a recompute its output handed back from
    ``saved``; both save ``(x, w)`` so the checkpoint's saved-tensor order is
    the same in the forward and the recompute. The backward computes what
    ``F.linear``'s does: ``dy @ w``, ``dy^T @ x`` and the bias sum."""

    @staticmethod
    def forward(ctx, x, w, b, saved):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        if saved is None:
            return F.linear(x, w, b)
        out = torch.empty(saved.shape, dtype=saved.dtype, device=x.device)
        return out.copy_(saved, non_blocking=True)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dy2.mm(w).reshape(x.shape) if ctx.needs_input_grad[0] else None
        dw = dy2.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        db = dy2.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None


class _Offload:
    """One checkpointed call's projection outputs: kept (or copied to the
    arena's pinned buffers) in the forward, handed back in order in the
    recompute."""

    def __init__(self, arena: OffloadArena):
        self.arena = arena
        self.saved: List[torch.Tensor] = []
        self.replay = None

    @contextlib.contextmanager
    def forward(self):
        token = _ACTIVE.set(self)
        try:
            yield
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def recompute(self):
        self.replay = iter(self.saved)
        token = _ACTIVE.set(self)
        try:
            yield
        finally:
            _ACTIVE.reset(token)

    def linear(self, x, w, b) -> torch.Tensor:
        if self.replay is not None:
            return _Dense.apply(x, w, b, next(self.replay))
        y = _Dense.apply(x, w, b, None)
        if y.is_cuda:
            host = self.arena.take(y)
            host.copy_(y.detach(), non_blocking=True)
        else:
            host = y.detach()
        self.saved.append(host)
        return y


@contextlib.contextmanager
def _recompute(features: frozenset, offload: Optional[_Offload]):
    """The recompute's context: the forward's kernel features, the offload's
    hand-back where there is one, and no probe collector (the forward
    collected the body's sites once, as the JAX package traces it once)."""
    with fast_kernels(features), probes.suspended(), (
            offload.recompute() if offload is not None else contextlib.nullcontext()):
        yield


def offloaded_linear(x, w, b) -> Optional[torch.Tensor]:
    """``F.linear(x, w, b)`` through the active offloaded body, or None
    outside one (``core.attention.dense`` then runs its own product)."""
    active = _ACTIVE.get()
    return None if active is None else active.linear(x, w, b)


def run(remat: Optional[Tuple[str, OffloadArena]], fn: Callable, *args):
    """``fn(*args)``, checkpointed per ``remat`` (``(mode, arena)`` or None)
    where autograd records; without gradients (eval, the cache routes) the
    body runs as it is."""
    if remat is None or not torch.is_grad_enabled():
        return fn(*args)
    mode, arena = remat
    off = _Offload(arena) if mode == "offload" else None
    features = fast_features()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, context_fn=lambda: (
        off.forward() if off is not None else contextlib.nullcontext(), _recompute(features, off)))
