"""The train step (counterpart of ``perceiver_io_tpu/training/loop.py::
make_train_step``): gradients, the optimizer update and metrics for one
batch. PyTorch runs it eagerly; there is no ``jit``/``donate``, and the
``overlap`` and ``probes`` options have no counterpart yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from perceiver_io_tpu_torch.training.state import TrainState


def _chunk(x, i: int, k: int):
    if x is None:
        return None
    n = x.shape[0]
    if n % k != 0:
        raise ValueError(f"microbatch={k} does not divide batch size {n}")
    per = n // k
    return x[i * per:(i + 1) * per]


def make_train_step(loss_fn: Callable, microbatch: int = 1, sentinel: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; ``state`` is updated
    in place. ``loss_fn(model, batch, generator) -> (loss, metrics)``, e.g.
    ``clm_loss_fn``; ``batch`` is a dict of arrays (batch axis 0) or None.

    ``microbatch=k`` splits the batch into ``k`` equal chunks along axis 0:
    gradients and metrics are averaged over the chunks, then ONE optimizer
    update. The loss must weight every chunk equally: a loss declaring
    ``uniform_weighting = False`` is rejected here, and an undeclared one
    (``None``) is rejected at call time for a batch with a non-None
    ``pad_mask``.

    ``sentinel=True`` is the in-step non-finite skip: when the loss or any
    gradient is not finite, parameters and optimizer state (its moments and
    its schedule count) hold, the step still advances, and the metrics carry
    ``sentinel_skipped`` (0.0 or 1.0)."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if microbatch > 1 and getattr(loss_fn, "uniform_weighting", None) is False:
        raise ValueError(
            "this loss declares uniform_weighting=False (per-call count normalization, masked-LM "
            "style); microbatch > 1 would reweight tokens and scale count metrics by 1/k; use microbatch=1"
        )
    uniform_declared = getattr(loss_fn, "uniform_weighting", None) is True

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        opt = state.optimizer
        opt.zero_grad()
        if microbatch == 1:
            loss, metrics = loss_fn(state.model, batch, state.generator)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            if not uniform_declared and batch.get("pad_mask") is not None:
                raise ValueError("microbatch > 1 requires equal chunk weighting; padded batches normalize "
                                 "per-chunk and would reweight tokens; use microbatch=1")
            metrics = None
            for i in range(microbatch):
                chunk = {k: _chunk(v, i, microbatch) for k, v in batch.items()}
                chunk_loss, m = loss_fn(state.model, chunk, state.generator)
                chunk_loss.backward()  # the chunks' gradients sum in .grad
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
            torch._foreach_mul_(opt.grads(), 1.0 / microbatch)
            metrics = {k: v / microbatch for k, v in metrics.items()}
            loss = metrics["loss"]
        if not sentinel:
            state.apply_gradients()
            return state, metrics
        finite = [torch.isfinite(loss).reshape(1)] + [torch.isfinite(g).all().reshape(1) for g in opt.grads()]
        ok = torch.cat(finite).all()
        if bool(ok):
            state.apply_gradients()
        else:
            state.step += 1
        metrics["sentinel_skipped"] = 1.0 - ok.float()
        return state, metrics

    return train_step
