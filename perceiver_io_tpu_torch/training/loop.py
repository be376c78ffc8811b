"""The train and eval steps (counterpart of ``perceiver_io_tpu/training/loop.py::
make_train_step`` and ``make_eval_step``): gradients, the optimizer update and
metrics for one batch, and an evaluation of one batch. On the card each step
is a CUDA graph (``graphs.CapturedStep``), as the JAX package jits them; on
the CPU it runs eagerly. ``donate`` has no counterpart (the state is updated
in place), nor has the ``overlap`` option yet (ROADMAP A12 part 2).

A state sharded over a mesh (:func:`shard_train_state`: FSDP2's
``fully_shard`` over the mesh's ``(data, fsdp)`` plane) takes the same step,
run eagerly (a graph does not capture the collectives): each rank computes
its block of the global batch with its block's generator
(:func:`block_generator`), the loss is the global batch's
(``losses.global_batch_mean``), FSDP averages the gradients, the optimizer
chain updates the local shards with whole-tensor norms, the sentinel's
verdict is agreed across ranks, and the metrics are the ranks' mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from perceiver_io_tpu_torch.graphs import CapturedStep
from perceiver_io_tpu_torch.obs import probes as obs_probes
from perceiver_io_tpu_torch.obs import profiler
from perceiver_io_tpu_torch.training.losses import global_batch_mean
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


def _rank_mean(metrics: Dict) -> Dict:
    """The mean of each 0-d metric over the default group's ranks."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return metrics
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return {**metrics, **dict(zip(keys, stacked.unbind()))}


# spreads the batch blocks' seeds apart (a prime above any block count)
_BLOCK_SEED_STRIDE = 1_000_003


def block_generator(state: TrainState) -> Optional[torch.Generator]:
    """The generator of this rank's block of the global batch, for one step
    of a sharded state: seeded by a number every rank draws alike from
    ``state.generator`` (so the ranks advance it alike and a checkpoint
    holds one state) and by the block's index over data x fsdp. The blocks
    of a global batch draw their dropout masks and keep sets apart; the
    ranks of one block (its ``seq`` line) draw alike, as the
    sequence-parallel forward needs. None without a state generator."""
    gen = state.generator
    if gen is None:
        return None
    from perceiver_io_tpu_torch.parallel.mesh import batch_index

    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed + _BLOCK_SEED_STRIDE * batch_index(state.mesh))


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
    (``obs.probes.suspended``).

    A sharded state (``state.mesh`` set by :func:`shard_train_state`) runs
    the step eagerly whatever ``jit`` says (see the module docstring); every
    rank calls it with its block of the batch. Probes on a sharded state
    raise (ROADMAP A12 part 2)."""
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
            if opt.dparams is not None:
                # every rank holds other gradient shards: skip on all or none
                agreed = ok.to(torch.int32)
                dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
                ok = agreed.bool()
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
            if state.mesh is not None:
                if probes is not None:
                    raise NotImplementedError("probes on a sharded state wait for ROADMAP A12 part 2")
                with global_batch_mean():
                    metrics = _rank_mean(body(state.model, state.optimizer, block_generator(state), batch))
            elif captured is not None and dev.type == "cuda":
                gen = state.generator
                metrics = captured(*parts, batch=batch, device=dev,
                                   generators=() if gen is None or gen.device.type != "cuda" else (gen,))
            else:
                metrics = body(*parts, batch)
        state.step += 1
        return state, metrics

    train_step.captured = captured
    return train_step


def make_eval_step(eval_fn: Callable, sharded: bool = False) -> Callable:
    """``eval_step(model, batch) -> eval_fn(model, batch)`` under
    ``torch.no_grad()`` (the JAX package's jitted ``eval_step(params,
    batch)``): a CUDA graph when the model lies on the card, captured at the
    first call and again when the batch's keys, shapes or dtypes change, and
    eager on the CPU. ``eval_fn`` must not sync with the host on the card.
    The returned function's ``captured`` attribute is the
    :class:`~perceiver_io_tpu_torch.graphs.CapturedStep`.

    ``sharded=True`` evaluates a sharded model (every rank with its block of
    the batch): eagerly, the losses the global batch's, the metrics the
    ranks' mean."""
    captured = CapturedStep(eval_fn, "the eval step")

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        dev = _device_of(model)
        if sharded:
            with global_batch_mean():
                return _rank_mean(eval_fn(model, batch))
        if dev.type == "cuda":
            return captured(model, batch=batch, device=dev)
        return eval_fn(model, batch)

    eval_step.captured = captured
    return eval_step


def train_state_shardings(state: TrainState, mesh, min_weight_size: int = 2**14) -> Dict[str, Optional[int]]:
    """``{parameter name: the dim sharded over fsdp, or None}``: JAX's
    placement of each parameter (``parallel.mesh.fsdp_param_shardings``);
    optimizer moments mirror their parameters, scalars are replicated."""
    from perceiver_io_tpu_torch.parallel.mesh import fsdp_param_shardings

    return fsdp_param_shardings(state.model, mesh, min_weight_size)


# the entry points besides forward that callers reach directly: of the root,
# and of a cross-attention layer unit
_ROOT_METHODS = ("seq_parallel_forward",)
_CROSS_ATTENTION_METHODS = ("seq_parallel", "call_with_split_kv")


def shard_train_state(state: TrainState, mesh, min_weight_size: int = 2**14) -> TrainState:
    """Place ``state`` on ``mesh``, in place, and return it: FSDP2's
    ``fully_shard`` on each cross- and self-attention layer, then on the root
    (which keeps the tied input/output embedding in one unit), over the
    mesh's 2-D ``(replicate, fsdp)`` plane (``parallel.mesh.replicate_group_mesh``:
    HSDP, replicated over ``data`` and ``seq``, sharded over ``fsdp``), each
    parameter on the dim JAX shards (``parallel.mesh.fsdp_placement_fn``);
    then the optimizer rebuilt over the sharded parameters, its state (a
    trained one's too) carried over shard by shard. The model keeps its class
    (FSDP2 subclasses it) and attributes. ``state.mesh`` records the mesh.

    Placing a state twice on the same mesh is free (it is returned as is);
    a state placed on another mesh raises (the reshard is ROADMAP A12
    part 2). FSDP2 shards every parameter of a unit, where JAX keeps those
    under ``min_weight_size`` replicated: the values are the same."""
    if state.mesh is mesh:
        return state
    if state.mesh is not None:
        raise NotImplementedError("the state is sharded over another mesh; placing it on a mesh of another "
                                  "shape (the elastic reshard) waits for ROADMAP A12 part 2")
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from perceiver_io_tpu_torch.core.modules import CrossAttentionLayer, SelfAttentionLayer
    from perceiver_io_tpu_torch.parallel.mesh import fsdp_placement_fn, local_chunk, replicate_group_mesh

    model = state.model
    placement = fsdp_placement_fn(model, mesh, min_weight_size)
    plane = replicate_group_mesh(mesh)
    old = state.optimizer
    old_state, owners = old.state_tensors(), old.state_owners()
    for module in list(model.modules()):
        if isinstance(module, (CrossAttentionLayer, SelfAttentionLayer)) and module is not model:
            fully_shard(module, mesh=plane, shard_placement_fn=placement)
            if isinstance(module, CrossAttentionLayer):
                for name in _CROSS_ATTENTION_METHODS:
                    register_fsdp_forward_method(module, name)
    fully_shard(model, mesh=plane, shard_placement_fn=placement)
    for name in _ROOT_METHODS:
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    opt = old.like(model.named_parameters())
    n = len(opt.params)
    with torch.no_grad():
        for i, (new_t, old_t, owner) in enumerate(zip(opt.state_tensors(), old_state, owners)):
            if i < n:
                continue  # the parameters, which fully_shard sharded
            new_t.copy_(old_t if owner is None else local_chunk(old_t, opt.dparams[owner]))
    state.optimizer = opt
    state.mesh = mesh
    return state
