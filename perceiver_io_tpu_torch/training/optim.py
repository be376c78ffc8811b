"""The optimizer and LR schedules (counterpart of
``perceiver_io_tpu/training/optim.py``: ``make_optimizer("adamw", ...)``,
``cosine_with_warmup``, ``constant_with_warmup``).

What the JAX package chains in optax, the port applies as one
:class:`Optimizer`:

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
- the LR schedule indexed by the count of applied updates from 0, as optax's
  count is: the first update uses ``lr(0)``, and an update the train step
  skips (non-finite gradients) does not advance it.

The count, the learning rate, AdamW's step and its moments are tensors on the
parameters' device, created with the optimizer, and an update reads and
writes them there without a host sync, so a train step captured into a CUDA
graph (``training.loop``) replays it: the schedule is evaluated on the count
tensor, as optax evaluates it on its traced count. On the card AdamW runs
with ``capturable=True``; on the CPU, where torch refuses that, with
``fused=True``, which also reads its step and learning rate from tensors.
The compact update is capturable as written (its bias corrections read the
count tensor, its rate the rate tensor).

The ``"adam"`` optimizer (with or without compact moments), Lamb and SGD are
not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

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


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global L2
    norm exceeds ``max_norm`` (optax's ``clip_by_global_norm``; a NaN norm
    makes every gradient NaN, as there). Returns the norm, without a host
    sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class CompactAdam:
    """``scale_by_adam_compact`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate`` (the JAX package's ``make_optimizer("adamw",
    moment_dtype=...)``) over one parameter list: moments ``mu``/``nu``
    stored in ``moment_dtype``, the update in f32, every operation in optax's
    order, so each rounding falls where the JAX package's does."""

    def __init__(self, params: List[torch.nn.Parameter], betas, weight_decay: float, moment_dtype: torch.dtype,
                 eps: float = 1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.weight_decay, self.eps = weight_decay, eps
        self.mu = [torch.zeros_like(p, dtype=moment_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], count: torch.Tensor, lr: torch.Tensor) -> None:
        """One update from f32 ``grads``; ``count`` is the number of updates
        applied before this one (optax's count then becomes ``count + 1``),
        ``lr`` the 0-d rate."""
        b1, b2 = self.b1, self.b2
        t = (count + 1).to(torch.float32)
        bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        # m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g g in f32, the
        # gradient term's last product fused into the sum (one rounding of
        # a * g + round(beta * moment)), as XLA contracts them in the JAX
        # package's jitted update: that product of two f32 values is exact
        # in f64, so the f64 sum rounded to f32 is the fused result
        m = self._fused(grads, torch.tensor(1.0 - b1, dtype=torch.float32).item(),
                        torch._foreach_mul([x.float() for x in self.mu], b1))
        v = self._fused(grads, torch._foreach_mul(grads, 1.0 - b2), torch._foreach_mul([x.float() for x in self.nu], b2))
        torch._foreach_copy_(self.mu, m)
        torch._foreach_copy_(self.nu, v)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)

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


class Optimizer:
    """Global-norm clip + AdamW (torch's, or :class:`CompactAdam` with
    ``moment_dtype``) + LR schedule over one parameter list (see the module
    docstring). ``step()`` applies one update from the parameters'
    ``.grad``; a parameter without one is updated as with a zero gradient, as
    optax does. ``count`` (applied updates, the schedule's index) and ``lr``
    are 0-d tensors on the parameters' device."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule, weight_decay: float,
                 betas, gradient_clip: Optional[float], moment_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.adamw, self.compact = None, None
        if moment_dtype is not None:
            self.compact = CompactAdam(self.params, betas, weight_decay, moment_dtype)
            return
        on_card = dev.type == "cuda"
        # on the card the multi-tensor form: torch's single-tensor capturable
        # form divides by the learning rate, and at a rate of 0 (a warmup's
        # first step) turns every parameter whose second moment is 0 into NaN
        self.adamw = torch.optim.AdamW(self.params, lr=self.lr, betas=betas, eps=1e-8, weight_decay=weight_decay,
                                       capturable=on_card, foreach=on_card, fused=not on_card)
        # AdamW's state as its first step would create it (step 0, zero
        # moments), made now: the non-finite select holds it from the first
        # update on, and a capture finds it in place
        for p in self.params:
            self.adamw.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=dev),
                                   "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                   "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def grads(self) -> List[torch.Tensor]:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> None:
        grads = self.grads()
        if self.gradient_clip is not None:
            clip_by_global_norm_(grads, self.gradient_clip)
        lr = self._scheduled_lr()
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)
        if self.compact is not None:
            self.compact.step(grads, self.count, self.lr)
        else:
            self.adamw.step()
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

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor an update writes: the parameters, the moments (and
        AdamW's step), the count."""
        out = list(self.params)
        if self.compact is not None:
            return out + self.compact.state_tensors() + [self.count]
        for p in self.params:
            state = self.adamw.state[p]
            out += [state["exp_avg"], state["exp_avg_sq"], state["step"]]
        return out + [self.count]

    @torch.no_grad()
    def step_where(self, ok: torch.Tensor) -> None:
        """One update where the 0-d bool ``ok`` holds, none where it does not,
        selected on the device (the JAX package's ``jnp.where(ok, updated,
        held)``): where it holds, the result is :meth:`step`'s exactly."""
        tensors = self.state_tensors()
        held = [t.clone() for t in tensors]
        self.step()
        for t, h in zip(tensors, held):
            torch.where(ok, t, h, out=t)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(learning_rate: Union[float, Schedule], optimizer: str = "adamw", weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999, gradient_clip: Optional[float] = None,
                   moment_dtype: Optional[Union[str, torch.dtype]] = None,
                   ) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """A factory ``tx(params) -> Optimizer`` (``TrainState.create`` calls
    it): the port's ``make_optimizer("adamw", gradient_clip=...,
    weight_decay=..., moment_dtype=...)``. ``moment_dtype`` (``"bfloat16"``
    or a torch dtype) stores the Adam moments in it (:class:`CompactAdam`);
    None keeps torch's AdamW with f32 moments. Only AdamW is ported."""
    if moment_dtype is not None and optimizer not in ("adamw", "adam"):
        raise ValueError(f"moment_dtype is only supported for adam/adamw, not {optimizer}")
    if optimizer != "adamw":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported (only 'adamw')")
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    schedule = learning_rate if callable(learning_rate) else (lambda step, lr=float(learning_rate): lr)

    def tx(params: Iterable[torch.nn.Parameter]) -> Optimizer:
        return Optimizer(params, schedule, weight_decay, (beta1, beta2), gradient_clip, moment_dtype)

    return tx
