"""The train and eval steps (counterpart of ``perceiver_io_tpu/training/loop.py::
make_train_step`` and ``make_eval_step``): gradients, the optimizer update and
metrics for one batch, and an evaluation of one batch. On the card each step
is a CUDA graph (``graphs.CapturedStep``), as the JAX package jits them; on
the CPU it runs eagerly. ``donate`` has no counterpart (the state is updated
in place), nor has the ``overlap`` option yet (ROADMAP A12 part 2, slice 2).

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


def _rank_mean(metrics: Dict, mesh) -> Dict:
    """The global batch's metrics from the ranks' blocks: each 0-d floating
    metric (a block's mean) averaged over the default group's ranks, each
    0-d integer metric (a block's count, the masked LM's ``num_masked``)
    summed over the batch blocks, as JAX's GSPMD step counts the global
    batch (the ranks of one block, its ``tensor`` and ``seq`` line, count it
    once)."""
    scalars = {k: v for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0}
    means = [k for k, v in scalars.items() if v.is_floating_point()]
    counts = [k for k in scalars if k not in means]
    out = dict(metrics)
    world = dist.get_world_size()
    if means:
        stacked = torch.stack([metrics[k].float() for k in means])
        dist.all_reduce(stacked)
        out.update(zip(means, (stacked / world).unbind()))
    if counts:
        from perceiver_io_tpu_torch.parallel.mesh import batch_shards

        stacked = torch.stack([metrics[k].long() for k in counts])
        dist.all_reduce(stacked)
        stacked //= world // batch_shards(mesh)
        out.update({k: v.to(metrics[k].dtype) for k, v in zip(counts, stacked.unbind())})
    return out


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
    raise (ROADMAP A12 part 2, slice 2)."""
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
                    raise NotImplementedError("probes on a sharded state wait for ROADMAP A12 part 2, slice 2")
                with global_batch_mean():
                    metrics = _rank_mean(body(state.model, state.optimizer, block_generator(state), batch),
                                         state.mesh)
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


def make_eval_step(eval_fn: Callable, mesh=None) -> Callable:
    """``eval_step(model, batch) -> eval_fn(model, batch)`` under
    ``torch.no_grad()`` (the JAX package's jitted ``eval_step(params,
    batch)``): a CUDA graph when the model lies on the card, captured at the
    first call and again when the batch's keys, shapes or dtypes change, and
    eager on the CPU. ``eval_fn`` must not sync with the host on the card.
    The returned function's ``captured`` attribute is the
    :class:`~perceiver_io_tpu_torch.graphs.CapturedStep`.

    With ``mesh`` it evaluates a model sharded over it (every rank with its
    block of the batch): eagerly, the losses and the metrics the global
    batch's (:func:`_rank_mean`)."""
    captured = CapturedStep(eval_fn, "the eval step")

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        dev = _device_of(model)
        if mesh is not None:
            with global_batch_mean():
                return _rank_mean(eval_fn(model, batch), mesh)
        if dev.type == "cuda":
            return captured(model, batch=batch, device=dev)
        return eval_fn(model, batch)

    eval_step.captured = captured
    return eval_step


def train_state_shardings(state: TrainState, mesh, min_weight_size: int = 2**14
                          ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """``{parameter name: (tensor dim, fsdp dim)}``, each None where the axis
    does not shard it: JAX's placement of each parameter
    (``parallel.mesh.param_shardings``); optimizer moments mirror their
    parameters, scalars are replicated."""
    from perceiver_io_tpu_torch.parallel.mesh import param_shardings

    return param_shardings(state.model, mesh, min_weight_size)


# the entry points besides forward that callers reach directly: of the root,
# and of a cross-attention layer unit
_ROOT_METHODS = ("seq_parallel_forward",)
_CROSS_ATTENTION_METHODS = ("seq_parallel", "call_with_split_kv")


def _skeleton(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` with its parameters on the meta device (no
    memory) and its buffers copied to the CPU: what a re-placement rebuilds
    the unsharded model from."""
    import copy

    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update({id(b): b.detach().cpu().clone() for b in model.buffers()})
    return copy.deepcopy(model, memo)


def _unshard(state: TrainState) -> None:
    """Bring a sharded ``state`` back to one unsharded model and optimizer on
    every rank, in place (a collective over its mesh): the whole parameters
    and optimizer state gathered (as a checkpoint gathers them) into a model
    built from the skeleton kept at the first placement."""
    import copy

    from perceiver_io_tpu_torch.training.checkpoint import _whole_payload

    weights, moments = _whole_payload(state, weights_only=False)
    dev = next(iter(weights.values())).device
    model = copy.deepcopy(state.template).to_empty(device=dev)
    with torch.no_grad():
        for (_, b), (_, src) in zip(model.named_buffers(), state.template.named_buffers()):
            b.copy_(src)
        model.load_state_dict(weights, strict=True)
        opt = state.optimizer.like(model.named_parameters())
        for new_t, full in zip(opt.state_tensors()[len(opt.params):], moments):
            new_t.copy_(full)
    state.model, state.optimizer, state.mesh, state.placement = model, opt, None, None


def _apply_tensor_parallel(model: torch.nn.Module, mesh) -> None:
    """``parallelize_module`` over the mesh's ``tensor`` axis: the Linears of
    ``parallel.mesh.tensor_parallel_linears`` column- and row-parallel, and
    each of those attentions holding its local heads."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.parallel.mesh import AXIS_TENSOR, axis_size, tensor_parallel_linears

    t = axis_size(mesh, AXIS_TENSOR)
    linears = tensor_parallel_linears(model, t)
    if not linears:
        return
    parallelize_module(model, mesh[AXIS_TENSOR],
                       {name: ColwiseParallel() if kind == "col" else RowwiseParallel()
                        for name, kind in linears.items()})
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention) and f"{name}.q_proj".lstrip(".") in linears:
            m.shard_heads(t)


def shard_train_state(state: TrainState, mesh, min_weight_size: int = 2**14,
                      tensor_parallel: Optional[bool] = None) -> TrainState:
    """Place ``state`` on ``mesh``, in place, and return it.

    With ``tensor_parallel`` (by default where the mesh's ``tensor`` axis
    exceeds 1; True applies the plan over an axis of 1 too), first
    ``parallelize_module`` over the ``tensor`` axis: ``q/k/v_proj`` and the
    MLPs' ``dense_1`` column-parallel, ``o_proj`` and ``dense_2``
    row-parallel, in the attentions whose heads the axis divides (each then
    holds its local heads) and the MLPs whose hidden width it divides
    (``parallel.mesh.tensor_parallel_linears``; JAX's rule, except that an
    attention whose heads the axis does not divide stays replicated where
    GSPMD would split its heads). Then FSDP2's ``fully_shard`` on each cross-
    and self-attention layer and on the root (which keeps the tied
    input/output embedding in one unit), over the mesh's 2-D
    ``(replicate, fsdp)`` plane (``parallel.mesh.replicate_group_mesh``:
    HSDP, replicated over ``data`` and ``seq``, sharded over ``fsdp``, the
    ``tensor`` axis left out), each parameter on the fsdp dim JAX shards
    (``parallel.mesh.param_shardings``: a dim the tensor axis does not
    take); then the optimizer rebuilt over the sharded parameters, its state
    (a trained one's too) carried over block by block. The model keeps its
    class (FSDP2 subclasses it) and attributes. ``state.mesh`` records the
    mesh, ``state.placement`` JAX's placement of each parameter, and
    ``state.template`` the model's unsharded skeleton.

    Placing a state twice on the same mesh is free (it is returned as is). A
    state placed on another mesh is re-placed, as JAX's is (the elastic
    reshard): its parameters and optimizer state gathered whole on every
    rank, an unsharded model built from the skeleton, and that placed on
    ``mesh``; ``state.model`` and ``state.optimizer`` are then new objects.
    FSDP2 shards every parameter of a unit, where JAX keeps those under
    ``min_weight_size`` replicated, and on dim 0 where JAX shards none: the
    values are the same."""
    if state.mesh is mesh:
        return state
    if state.mesh is not None:
        _unshard(state)
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from perceiver_io_tpu_torch.core.modules import CrossAttentionLayer, SelfAttentionLayer
    from perceiver_io_tpu_torch.parallel.mesh import (
        AXIS_TENSOR,
        axis_size,
        fsdp_placement_fn,
        local_chunk,
        param_shardings,
        replicate_group_mesh,
    )

    model = state.model
    if tensor_parallel is None:
        tensor_parallel = axis_size(mesh, AXIS_TENSOR) > 1
    dims = param_shardings(model, mesh, min_weight_size, tensor_size=None if tensor_parallel else 1)
    template = state.template if state.template is not None else _skeleton(model)
    plane = replicate_group_mesh(mesh)
    if tensor_parallel:
        _apply_tensor_parallel(model, mesh)
    placement = fsdp_placement_fn(model, {name: d[1] for name, d in dims.items()})
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
    state.mesh, state.placement, state.template = mesh, dims, template
    return state
