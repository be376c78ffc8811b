"""The train and eval steps (counterpart of ``perceiver_io_tpu/training/loop.py::
make_train_step`` and ``make_eval_step``): gradients, the optimizer update and
metrics for one batch, and an evaluation of one batch. On the card each step
is a CUDA graph (``graphs.CapturedStep``), as the JAX package jits them; on
the CPU it runs eagerly. ``donate`` has no counterpart (the state is updated
in place), nor has the ``overlap`` (parallelism) option yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from perceiver_io_tpu_torch.graphs import CapturedStep
from perceiver_io_tpu_torch.obs import probes as obs_probes
from perceiver_io_tpu_torch.obs import profiler
from perceiver_io_tpu_torch.training.state import TrainState


def _chunk(x, i: int, k: int):
    if x is None:
        return None
    n = x.shape[0]
    if n % k != 0:
        raise ValueError(f"microbatch={k} does not divide batch size {n}")
    per = n // k
    return x[i * per:(i + 1) * per]


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(loss_fn: Callable, microbatch: int = 1, sentinel: bool = False, jit: bool = True,
                    probes: Optional[obs_probes.ProbeConfig] = None) -> Callable:
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
    gradient is not finite, parameters and optimizer state (its moments, its
    schedule count, an accumulation's running mean and counters) hold, the
    step still advances, and the metrics carry
    ``sentinel_skipped`` (0.0 or 1.0, a tensor). The update is applied and
    then selected on the device, as the JAX package's ``jnp.where``.

    ``jit=True`` (the default) runs the step as a CUDA graph when the model
    lies on the card: the forward and backward of every chunk (a
    checkpointed layer's recompute included), the 1/k scale, the optimizer
    call (clip, update rule, accumulation) and the select are one graph,
    captured at the first call (a real step) and again when the batch's
    keys, shapes or dtypes change; each call copies the batch into the
    graph's buffers.
    A CUDA generator in ``state.generator`` draws fresh numbers at every
    replay; the returned function's ``captured`` attribute is the
    :class:`~perceiver_io_tpu_torch.graphs.CapturedStep` (its ``graph`` the
    current capture). Before the first call, drop any eager forward's
    autograd graph over the same parameters (its loss and metrics): its
    gradient accumulators would run the captured backward on the stream
    they were made on, which a capture refuses. ``jit=False``, or a model
    on the CPU, runs the step eagerly (``captured`` is None).

    ``probes=ProbeConfig(...)`` (``obs/probes.py``) adds the numerics
    telemetry to the step, as outputs of the same graph: each chunk's loss
    forward runs under a probe collector (per-scope activation rms / absmax
    / non-finite / zero stats at the model's probe sites, averaged over the
    ``microbatch`` chunks as the JAX package averages its metrics), then the
    per-bucket gradient norms of the averaged gradients (before the clip)
    and, after the update, the per-bucket update/parameter ratios (the step
    keeps a copy of the parameters from before the update for them: one
    parameter set of memory) — all under ``metrics["probes"]``, ordered
    keys. Under ``sentinel=True`` the ratios read the selected parameters,
    so a skipped step's are 0 (the JAX package reads the update before its
    select). ``None`` (the default) runs exactly the step without probes.
    A checkpointed layer's recompute is not collected
    (``obs.probes.suspended``)."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if microbatch > 1 and getattr(loss_fn, "uniform_weighting", None) is False:
        raise ValueError(
            "this loss declares uniform_weighting=False (per-call count normalization, masked-LM "
            "style); microbatch > 1 would reweight tokens and scale count metrics by 1/k; use microbatch=1"
        )
    uniform_declared = getattr(loss_fn, "uniform_weighting", None) is True
    collect = probes is not None and probes.activations
    buckets: Dict[int, Dict] = {}  # the model's parameter buckets, by id(model)

    def forward(model, batch: Dict, generator, snapshots: list):
        if not collect:
            return loss_fn(model, batch, generator)
        with obs_probes.collecting(probes) as col:
            out = loss_fn(model, batch, generator)
        snapshots.append(col.stats)
        return out

    def body(model, opt, generator, batch: Dict) -> Dict:
        """Gradients, the update and the metrics of one batch, on the device
        alone (no host sync)."""
        opt.zero_grad()
        snapshots: list = []
        if microbatch == 1:
            loss, metrics = forward(model, batch, generator, snapshots)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            metrics = None
            for i in range(microbatch):
                chunk = {k: _chunk(v, i, microbatch) for k, v in batch.items()}
                chunk_loss, m = forward(model, chunk, generator, snapshots)
                chunk_loss.backward()  # the chunks' gradients sum in .grad
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
            torch._foreach_mul_(opt.grads(), 1.0 / microbatch)
            metrics = {k: v / microbatch for k, v in metrics.items()}
            loss = metrics["loss"]
        grad_stats, old = {}, None
        if probes is not None:
            if id(model) not in buckets:
                buckets[id(model)] = obs_probes.param_buckets(model, probes.bucket_depth)
            params = buckets[id(model)]
            opt.grads()  # a parameter the loss did not reach gets its zero gradient
            if probes.grad_norms:  # before the update: the clip rewrites the gradients
                grad_stats = obs_probes.grad_bucket_stats({b: [p.grad for p in ps] for b, ps in params.items()})
            if probes.update_ratio:
                old = {b: obs_probes.flat(ps) for b, ps in params.items()}  # a copy: flat() concatenates
        if not sentinel:
            opt.step()
        else:
            finite = [torch.isfinite(loss).reshape(1)] + [torch.isfinite(g).all().reshape(1) for g in opt.grads()]
            ok = torch.cat(finite).all()
            opt.step_where(ok)
            metrics["sentinel_skipped"] = 1.0 - ok.float()
        if probes is not None:
            metrics["probes"] = obs_probes.attach_train_stats(
                obs_probes.mean_stats(snapshots) if snapshots else {}, grad_stats,
                {} if old is None else obs_probes.update_ratio_stats(old, params))
        return metrics

    captured = CapturedStep(body, "the train step") if jit else None

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if microbatch > 1 and not uniform_declared and batch.get("pad_mask") is not None:
            raise ValueError("microbatch > 1 requires equal chunk weighting; padded batches normalize "
                             "per-chunk and would reweight tokens; use microbatch=1")
        parts = (state.model, state.optimizer, state.generator)
        dev = _device_of(state.model)
        # the profiler's scope of the step (obs.profiler): a replay's kernels
        # land under it, an eager step's too
        with profiler.scope("train_step"):
            if captured is not None and dev.type == "cuda":
                gen = state.generator
                metrics = captured(*parts, batch=batch, device=dev,
                                   generators=() if gen is None or gen.device.type != "cuda" else (gen,))
            else:
                metrics = body(*parts, batch)
        state.step += 1
        return state, metrics

    train_step.captured = captured
    return train_step


def make_eval_step(eval_fn: Callable) -> Callable:
    """``eval_step(model, batch) -> eval_fn(model, batch)`` under
    ``torch.no_grad()`` (the JAX package's jitted ``eval_step(params,
    batch)``): a CUDA graph when the model lies on the card, captured at the
    first call and again when the batch's keys, shapes or dtypes change, and
    eager on the CPU. ``eval_fn`` must not sync with the host on the card.
    The returned function's ``captured`` attribute is the
    :class:`~perceiver_io_tpu_torch.graphs.CapturedStep`."""
    captured = CapturedStep(eval_fn, "the eval step")

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        dev = _device_of(model)
        if dev.type == "cuda":
            return captured(model, batch=batch, device=dev)
        return eval_fn(model, batch)

    eval_step.captured = captured
    return eval_step
