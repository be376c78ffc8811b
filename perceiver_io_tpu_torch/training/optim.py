"""The optimizer and LR schedules (counterpart of
``perceiver_io_tpu/training/optim.py``: ``make_optimizer``, ``freeze_mask``,
``cosine_with_warmup``, ``constant_with_warmup``).

What the JAX package chains in optax, the port applies as one
:class:`Optimizer`:

- with a frozen mask, ``masked(set_to_zero())`` on the gradients first (a
  frozen gradient enters neither the clip's norm nor the moments) and on the
  updates last (AdamW's decay would move a frozen parameter): the port zeroes
  the frozen gradients and puts the frozen parameters back after the update;
- ``clip_by_global_norm(max_norm)``, exactly optax's: the gradients are scaled
  by ``max_norm / norm`` only when their global norm exceeds ``max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not
  used);
- optax's ``adamw``, which ``torch.optim.AdamW`` computes: bias-corrected
  moments, ``eps`` outside the square root, weight decay decoupled, applied
  to the pre-step parameter and to every parameter;
- or, with ``moment_dtype`` (``make_optimizer(..., moment_dtype="bfloat16")``),
  the JAX package's chain ``scale_by_adam_compact`` -> ``add_decayed_weights``
  -> ``scale_by_learning_rate``: the moments are STORED in ``moment_dtype``
  and the update is computed in f32 (the moments upcast, updated, rounded to
  nearest even on store), the weight decay added to the update (optax's
  order, not torch's decay of the pre-step parameter), written by hand with
  ``torch._foreach_*`` ops (``torch.optim.AdamW`` keeps its moments in the
  parameters' dtype);
- ``"adam"``: the same without decay (compact or not); ``"lamb"``: optax's
  ``lamb`` (:class:`Lamb`); ``"sgd"``: ``-lr * g``;
- the LR schedule indexed by the count of applied updates from 0, as optax's
  count is: the first update uses ``lr(0)``, and an update the train step
  skips (non-finite gradients) does not advance it;
- with ``accumulate_grad_batches`` k > 1, optax's ``MultiSteps`` around all of
  it: the running mean of the gradients, the inner update computed at every
  call and selected on the device at every k-th (``where(emit, new, held)``),
  so a captured step stays one graph.

The count, the learning rate, AdamW's step and its moments are tensors on the
parameters' device, created with the optimizer, and an update reads and
writes them there without a host sync, so a train step captured into a CUDA
graph (``training.loop``) replays it: the schedule is evaluated on the count
tensor, as optax evaluates it on its traced count. On the card AdamW runs
with ``capturable=True``; on the CPU, where torch refuses that, with
``fused=True``, which also reads its step and learning rate from tensors.
The compact, Lamb and SGD updates are capturable as written (their bias
corrections read the count tensor, their rate the rate tensor).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import torch

# step -> learning rate; a schedule the train step can capture takes a 0-d
# tensor step and returns a tensor on its device (Python numbers otherwise)
Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


def _in_kind(step, value: torch.Tensor):
    """A schedule's f64 result: a tensor for a tensor step, a float for an
    int step."""
    return value if isinstance(step, torch.Tensor) else float(value)


def cosine_with_warmup(base_lr: float, training_steps: int, warmup_steps: int = 0, num_cycles: float = 0.5,
                       min_fraction: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to ``min_fraction * base_lr``; in f64,
    for an int step or a 0-d tensor step on any device."""

    def schedule(step):
        s = torch.as_tensor(step, dtype=torch.float64)
        warm = base_lr * s / max(1, warmup_steps)
        progress = (s - warmup_steps) / max(1, training_steps - warmup_steps)
        cosine = 0.5 * (1.0 - min_fraction) * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress))
        decayed = base_lr * (min_fraction + torch.clamp(cosine, min=0.0))
        return _in_kind(step, torch.where(s < warmup_steps, warm, decayed))

    return schedule


def constant_with_warmup(base_lr: float, warmup_steps: int = 0) -> Schedule:
    """Linear warmup then constant; in f64, for an int or a 0-d tensor step."""

    def schedule(step):
        s = torch.as_tensor(step, dtype=torch.float64)
        return _in_kind(step, base_lr * torch.clamp(s / max(1, warmup_steps), max=1.0))

    return schedule


def shard_groups(dparams) -> List[tuple]:
    """``[(group, mask)]`` for the DTensors ``dparams`` (FSDP2's sharded
    parameters, tensor-parallel ones among them): for each mesh dim, by
    name, along which some of them are sharded, its process group and the
    bool mask of those that are (a tensor-parallel block is sharded over
    ``fsdp`` and ``tensor``, a replicated layer's parameter over ``fsdp``
    alone)."""
    dims: Dict[str, tuple] = {}
    for i, d in enumerate(dparams):
        mesh = d.device_mesh
        for j, placement in enumerate(d.placements):
            if placement.is_shard():
                name = mesh.mesh_dim_names[j]
                if name not in dims:
                    dims[name] = (mesh.get_group(j), set())
                dims[name][1].add(i)
    dev = dparams[0].to_local().device if dparams else None
    return [(group, torch.tensor([i in which for i in range(len(dparams))], device=dev))
            for group, which in dims.values()]


def tensor_norms(tensors: List[torch.Tensor], shards: Optional[List[tuple]] = None) -> torch.Tensor:
    """The L2 norm of each tensor, stacked; with ``shards``
    (:func:`shard_groups`) the tensors are this rank's blocks and each norm
    is the whole tensor's: the squares summed over each mesh dim the tensor
    is sharded along (an all-reduce over its group), never over a dim it is
    replicated along.

    A CUDA tensor that does not start on a 16-byte boundary is read from an
    aligned copy: torch's foreach norm sums an aligned tensor in vector loads
    and a misaligned one element-strided, two orders that round apart, and
    FSDP2's blocks are views at any offset of one flat buffer. The norm then
    depends on the values alone, so a block on one process sums as the whole
    tensor does."""
    tensors = [t.clone() if t.is_cuda and t.data_ptr() % 16 else t for t in tensors]
    norms = torch.stack(torch._foreach_norm(tensors))
    if not shards:
        return norms
    sq = norms.double() ** 2
    for group, mask in shards:
        part = torch.where(mask, sq, torch.zeros_like(sq))
        torch.distributed.all_reduce(part, group=group)
        sq = torch.where(mask, part, sq)
    return sq.sqrt().to(norms.dtype)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, shards: Optional[List[tuple]] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global L2
    norm exceeds ``max_norm`` (optax's ``clip_by_global_norm``; a NaN norm
    makes every gradient NaN, as there). Returns the norm, without a host
    sync. With ``shards`` the gradients are blocks and the norm is the whole
    gradients' (:func:`tensor_norms`)."""
    norm = torch.linalg.vector_norm(tensor_norms(grads, shards))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


# the elements a compact update works on at once (the largest flagship
# tensor, the position table, is 8.4M): its f64 temporaries then take about
# 0.2 GB where the whole parameter list's took about 1 GB at the flagship
COMPACT_BUCKET = 1 << 23


def _buckets(params: List[torch.Tensor], size: int) -> List[List[int]]:
    """Runs of consecutive parameter indices of at most ``size`` elements
    each (a larger tensor alone)."""
    out, n = [], size
    for i, p in enumerate(params):
        if n + p.numel() > size:
            out.append([])
            n = 0
        out[-1].append(i)
        n += p.numel()
    return out


class CompactAdam:
    """``scale_by_adam_compact`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate`` (the JAX package's ``make_optimizer("adamw",
    moment_dtype=...)``) over one parameter list: moments ``mu``/``nu``
    stored in ``moment_dtype``, the update in f32, every operation in optax's
    order, so each rounding falls where the JAX package's does. The update
    runs over buckets of at most ``COMPACT_BUCKET`` elements (element by
    element the same arithmetic), and, given the sentinel's flag, holds and
    selects one bucket at a time, so its transient memory is a bucket's."""

    def __init__(self, params: List[torch.nn.Parameter], betas, weight_decay: float, moment_dtype: torch.dtype,
                 eps: float = 1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.weight_decay, self.eps = weight_decay, eps
        self.mu = [torch.zeros_like(p, dtype=moment_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype) for p in params]
        self.buckets = _buckets(params, COMPACT_BUCKET)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor,
             ok: Optional[torch.Tensor] = None) -> None:
        """One update from f32 ``grads``; ``count`` is the number of updates
        applied before this one (optax's count then becomes ``count + 1``),
        ``lr`` the 0-d rate. With the 0-d bool ``ok``, parameters and moments
        end as they began where it is false (``Optimizer.step_where``)."""
        b1, b2 = self.b1, self.b2
        t = (count + 1).to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        for idx in self.buckets:
            ps, gs = [self.params[i] for i in idx], [grads[i] for i in idx]
            mus, nus = [self.mu[i] for i in idx], [self.nu[i] for i in idx]
            state = ps + mus + nus
            held = None if ok is None else [x.clone() for x in state]
            # m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g g in f32, the
            # gradient term's last product fused into the sum (one rounding
            # of a * g + round(beta * moment)), as XLA contracts them in the
            # JAX package's jitted update: that product of two f32 values is
            # exact in f64, so the f64 sum rounded to f32 is the fused result
            m = self._fused(gs, torch.tensor(1.0 - b1, dtype=torch.float32).item(),
                            torch._foreach_mul([x.float() for x in mus], b1))
            v = self._fused(gs, torch._foreach_mul(gs, 1.0 - b2), torch._foreach_mul([x.float() for x in nus], b2))
            torch._foreach_copy_(mus, m)
            torch._foreach_copy_(nus, v)
            den = torch._foreach_div(v, bc2)
            del v
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(m, bc1)
            del m
            torch._foreach_div_(u, den)
            del den
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(ps, u)
            if held is not None:
                for x, h in zip(state, held):
                    torch.where(ok, x, h, out=x)

    @staticmethod
    def _fused(a: List[torch.Tensor], b, c: List[torch.Tensor]) -> List[torch.Tensor]:
        """``a * b + c`` for f32 lists ``a`` and ``c`` and an f32 list or an
        f32-representable number ``b``, rounded once to f32."""
        out = [x.double() for x in a]
        torch._foreach_mul_(out, b if isinstance(b, float) else [x.double() for x in b])
        torch._foreach_add_(out, [x.double() for x in c])
        return [x.float() for x in out]

    def state_tensors(self) -> List[torch.Tensor]:
        return self.mu + self.nu

    def state_owners(self) -> List[Optional[int]]:
        return list(range(len(self.params))) * 2


class Lamb:
    """optax's ``lamb`` (the JAX package's ``make_optimizer("lamb")``):
    ``scale_by_adam(eps=1e-6, eps_root=0)`` -> ``add_decayed_weights`` ->
    ``scale_by_trust_ratio`` -> ``scale_by_learning_rate``, f32 moments. The
    trust ratio is per parameter tensor, ``|p| / |u|``, and 1 where either
    norm is 0 (optax's guard)."""

    def __init__(self, params: List[torch.nn.Parameter], betas, weight_decay: float, eps: float = 1e-6,
                 norm_shards=None):
        self.params = params
        self.b1, self.b2 = betas
        self.weight_decay, self.eps = weight_decay, eps
        self.norm_shards = norm_shards  # sharded parameters: the trust ratio reads whole-tensor norms
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor) -> None:
        b1, b2 = self.b1, self.b2
        t = (count + 1).to(torch.float32)
        # optax's update_moment: (1 - b) * g + b * m, and g * g for nu
        m = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(m, torch._foreach_mul(self.mu, b1))
        v = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(v, 1.0 - b2)
        torch._foreach_add_(v, torch._foreach_mul(self.nu, b2))
        torch._foreach_copy_(self.mu, m)
        torch._foreach_copy_(self.nu, v)
        u = torch._foreach_div(m, 1.0 - torch.pow(b1, t))
        den = torch._foreach_div(v, 1.0 - torch.pow(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        p_norm = tensor_norms(self.params, self.norm_shards)
        u_norm = tensor_norms(u, self.norm_shards)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
        for x, r in zip(u, ratio):
            x.mul_(r)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)

    def state_tensors(self) -> List[torch.Tensor]:
        return self.mu + self.nu

    def state_owners(self) -> List[Optional[int]]:
        return list(range(len(self.params))) * 2


class Sgd:
    """optax's ``sgd`` without momentum: the update ``-lr * g``."""

    def __init__(self, params: List[torch.nn.Parameter]):
        self.params = params

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor) -> None:
        torch._foreach_add_(self.params, torch._foreach_mul(grads, -lr))

    def state_tensors(self) -> List[torch.Tensor]:
        return []

    def state_owners(self) -> List[Optional[int]]:
        return []


class TorchAdamW:
    """optax's ``adamw`` (and, without decay, ``adam``) through
    ``torch.optim.AdamW``, which reads the parameters' ``.grad`` and keeps its
    own step; its state made as its first step would make it."""

    def __init__(self, params: List[torch.nn.Parameter], lr: torch.Tensor, betas, weight_decay: float):
        self.params = params
        dev = params[0].device
        on_card = dev.type == "cuda"
        # on the card the multi-tensor form: torch's single-tensor capturable
        # form divides by the learning rate, and at a rate of 0 (a warmup's
        # first step) turns every parameter whose second moment is 0 into NaN
        self.adamw = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay,
                                       capturable=on_card, foreach=on_card, fused=not on_card)
        # AdamW's state as its first step would create it (step 0, zero
        # moments), made now: the non-finite select holds it from the first
        # update on, and a capture finds it in place
        for p in params:
            self.adamw.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=dev),
                                   "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                   "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def step(self, grads: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor) -> None:
        self.adamw.step()

    def state_tensors(self) -> List[torch.Tensor]:
        out = []
        for p in self.params:
            state = self.adamw.state[p]
            out += [state["exp_avg"], state["exp_avg_sq"], state["step"]]
        return out

    def state_owners(self) -> List[Optional[int]]:
        return [o for i in range(len(self.params)) for o in (i, i, None)]


class Optimizer:
    """The JAX package's ``make_optimizer`` chain over one parameter list
    (see the module docstring): frozen gradients zeroed, global-norm clip,
    the update rule (``rule``: :class:`TorchAdamW`, :class:`CompactAdam`,
    :class:`Lamb` or :class:`Sgd`), frozen parameters held, the LR schedule;
    with ``accumulate`` > 1 all of it inside optax's ``MultiSteps``.
    ``step()`` applies one call from the parameters' ``.grad``; a parameter
    without one is updated as with a zero gradient, as optax does. ``count``
    (applied updates, the schedule's index) and ``lr`` are 0-d tensors on the
    parameters' device; so are ``mini_step`` and ``gradient_step`` (optax's
    ``MultiStepsState``) with accumulation.

    ``params`` are parameters or ``(name, parameter)`` pairs;
    ``frozen_mask`` (``{name: bool}``, :func:`freeze_mask`) needs the
    names.

    Sharded parameters (the DTensors of FSDP2's ``fully_shard``,
    ``training.loop.shard_train_state``): the chain runs on each rank's
    local shards (``params`` are those, ``dparams`` the DTensors, whose
    ``.grad`` shards :meth:`grads` hands over), and every norm it takes, the
    clip's global norm and LAMB's per-tensor trust-ratio norms, is the whole
    tensors' across the mesh dims they are sharded along (``norm_shards``,
    :func:`shard_groups`), not the local shard's."""

    def __init__(self, params: Iterable, schedule: Schedule, optimizer: str = "adamw", weight_decay: float = 0.01,
                 betas=(0.9, 0.999), gradient_clip: Optional[float] = None,
                 moment_dtype: Optional[torch.dtype] = None, frozen_mask: Optional[Dict[str, bool]] = None,
                 accumulate: int = 1):
        self._args = (schedule, optimizer, weight_decay, betas, gradient_clip, moment_dtype, frozen_mask, accumulate)
        items = list(params)
        named = bool(items) and isinstance(items[0], tuple)
        self.params = [p for _, p in items] if named else items
        self.dparams, self.norm_shards = None, None
        from torch.distributed.tensor import DTensor

        if self.params and isinstance(self.params[0], DTensor):
            self.dparams = self.params
            self.norm_shards = shard_groups(self.dparams)
            self.params = [p._local_tensor for p in self.dparams]
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.adamw, self.compact = None, None
        if moment_dtype is not None:
            self.rule = self.compact = CompactAdam(self.params, betas, weight_decay if optimizer == "adamw" else 0.0,
                                                   moment_dtype)
        elif optimizer in ("adamw", "adam"):
            self.rule = TorchAdamW(self.params, self.lr, betas, weight_decay if optimizer == "adamw" else 0.0)
            self.adamw = self.rule.adamw
        elif optimizer == "lamb":
            self.rule = Lamb(self.params, betas, weight_decay, norm_shards=self.norm_shards)
        else:
            self.rule = Sgd(self.params)
        self.frozen: List[torch.nn.Parameter] = []
        if frozen_mask is not None:
            if not named:
                raise ValueError("frozen_mask needs named parameters: pass (name, parameter) pairs "
                                 "(TrainState.create passes model.named_parameters())")
            names = [n for n, _ in items]
            if sorted(frozen_mask) != sorted(names):
                raise ValueError("frozen_mask must name every parameter (freeze_mask(model, paths) does)")
            self.frozen = [p for n, p in zip(names, self.params) if frozen_mask[n]]
        self.accumulate = accumulate
        if accumulate > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
            self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)
            self.gradient_step = torch.zeros((), dtype=torch.int32, device=dev)

    def like(self, params: Iterable) -> "Optimizer":
        """A fresh optimizer of this one's configuration over ``params``."""
        return Optimizer(params, *self._args)

    def grads(self) -> List[torch.Tensor]:
        if self.dparams is not None:
            for d, p in zip(self.dparams, self.params):
                if d.grad is not None:
                    p.grad = d.grad._local_tensor
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One call: the update from ``.grad``, or with accumulation optax's
        ``MultiSteps`` (the running mean ``acc + (g - acc) / (n + 1)``, the
        inner update computed on it at every call and kept only at every
        ``accumulate``-th, where the mean restarts from zero)."""
        grads = self.grads()
        if self.accumulate == 1:
            self._update(grads)
            return
        n = self.mini_step
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, (n + 1).to(torch.float32))
        torch._foreach_add_(self.acc, delta)
        torch._foreach_copy_(grads, self.acc)
        emit = n == self.accumulate - 1
        inner = self._inner_state()
        held = [t.clone() for t in inner]
        self._update(grads)
        for t, h in zip(inner, held):
            torch.where(emit, t, h, out=t)
        torch._foreach_mul_(self.acc, (~emit).to(torch.float32))
        self.gradient_step += emit.to(torch.int32)
        self.mini_step.copy_((n + 1) % self.accumulate)

    def _update(self, grads: List[torch.Tensor], ok: Optional[torch.Tensor] = None) -> None:
        """The inner chain: frozen gradients zeroed (before the clip, as
        optax's masked ``set_to_zero``), the clip, the rule, the frozen
        parameters put back (their update zeroed after the decay). ``ok``
        goes to the compact rule, which selects its own state."""
        held = None
        if self.frozen:
            torch._foreach_zero_([p.grad for p in self.frozen])
            held = [p.clone() for p in self.frozen]
        if self.gradient_clip is not None:
            clip_by_global_norm_(grads, self.gradient_clip, self.norm_shards)
        lr = self._scheduled_lr()
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)
        if ok is None:
            self.rule.step(grads, self.count, self.lr)
        else:
            self.rule.step(grads, self.count, self.lr, ok)
        if held is not None:
            torch._foreach_copy_(self.frozen, held)
        self.count += 1

    def _scheduled_lr(self):
        try:
            return self.schedule(self.count)
        except RuntimeError as e:
            if self.count.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the learning-rate schedule cannot take the update count as a 0-d tensor on the card: a "
                    "captured train step evaluates it there, as optax evaluates a schedule on its traced count; "
                    "write it with tensor operations, as cosine_with_warmup is written") from e
            raise

    def _inner_state(self) -> List[torch.Tensor]:
        return list(self.params) + self.rule.state_tensors() + [self.count]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a call writes: the parameters, the rule's state
        (moments, AdamW's steps), with accumulation the running mean and
        optax's two step counters, and the count, last."""
        out = list(self.params) + self.rule.state_tensors()
        if self.accumulate > 1:
            out += self.acc + [self.mini_step, self.gradient_step]
        return out + [self.count]

    def state_owners(self) -> List[Optional[int]]:
        """For each of :meth:`state_tensors`, the index of the parameter it
        mirrors (its shape and sharding), None for the rest."""
        n = len(self.params)
        out = list(range(n)) + self.rule.state_owners()
        if self.accumulate > 1:
            out += list(range(n)) + [None, None]
        return out + [None]

    @torch.no_grad()
    def step_where(self, ok: torch.Tensor) -> None:
        """One call where the 0-d bool ``ok`` holds, none where it does not,
        selected on the device (the JAX package's ``jnp.where(ok, updated,
        held)``): where it holds, the result is :meth:`step`'s exactly."""
        if self.compact is not None and self.accumulate == 1:
            # the compact update holds and selects its parameters and moments
            # a bucket at a time; the count is the rest of the state
            held_count = self.count.clone()
            self._update(self.grads(), ok)
            torch.where(ok, self.count, held_count, out=self.count)
            return
        tensors = self.state_tensors()
        held = [t.clone() for t in tensors]
        self.step()
        for t, h in zip(tensors, held):
            torch.where(ok, t, h, out=t)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        for d in self.dparams or ():
            d.grad = None


OPTIMIZERS = ("adamw", "adam", "lamb", "sgd")


def make_optimizer(learning_rate: Union[float, Schedule], optimizer: str = "adamw", weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999, gradient_clip: Optional[float] = None,
                   accumulate_grad_batches: int = 1, frozen_mask: Optional[Dict[str, bool]] = None,
                   moment_dtype: Optional[Union[str, torch.dtype]] = None,
                   ) -> Callable[[Iterable], Optimizer]:
    """A factory ``tx(params) -> Optimizer`` (``TrainState.create`` calls it
    with the model's named parameters): the JAX package's ``make_optimizer``.

    ``optimizer``: ``"adamw"`` (torch's AdamW), ``"adam"`` (no decay),
    ``"lamb"`` (optax's) or ``"sgd"``. ``moment_dtype`` (``"bfloat16"`` or a
    torch dtype; adam/adamw only) stores the Adam moments in it
    (:class:`CompactAdam`). ``accumulate_grad_batches`` > 1 is optax's
    ``MultiSteps`` around the whole chain. ``frozen_mask`` (``{name: bool}``
    from :func:`freeze_mask`) zeroes the frozen gradients before the clip and
    holds the frozen parameters."""
    if moment_dtype is not None and optimizer not in ("adamw", "adam"):
        raise ValueError(f"moment_dtype is only supported for adam/adamw, not {optimizer}")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer: {optimizer}")
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    schedule = learning_rate if callable(learning_rate) else (lambda step, lr=float(learning_rate): lr)

    def tx(params: Iterable) -> Optimizer:
        return Optimizer(params, schedule, optimizer, weight_decay, (beta1, beta2), gradient_clip, moment_dtype,
                         frozen_mask, accumulate_grad_batches)

    return tx


def freeze_mask(model: torch.nn.Module, frozen_paths: Sequence[str]) -> Dict[str, bool]:
    """``{name: frozen}`` over ``model.named_parameters()``: a parameter is
    frozen where the JAX package's path of its counterpart
    (:func:`convert.jax_param_paths`, ``params/...``) holds one of
    ``frozen_paths`` (``"a/b"`` strings) as a run of whole segments, the JAX
    package's ``freeze_mask`` rule (``"encoder"`` freezes
    ``params/encoder/...``, not ``params/image_encoder/...``)."""
    from perceiver_io_tpu_torch.convert import jax_param_paths

    patterns = [p.split("/") for p in frozen_paths]

    def frozen(path: str) -> bool:
        segments = path.split("/")
        return any(segments[i:i + len(pat)] == pat for pat in patterns for i in range(len(segments) - len(pat) + 1))

    return {name: frozen(path) for name, path in jax_param_paths(model).items()}
