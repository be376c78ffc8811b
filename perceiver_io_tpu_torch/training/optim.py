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
- the LR schedule indexed by the count of applied updates from 0, as optax's
  count is: the first update uses ``lr(0)``, and an update the train step
  skips (non-finite gradients) does not advance it.

Moments are f32. ``scale_by_adam_compact`` (bf16 moments), Lamb and SGD are
not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

Schedule = Callable[[int], float]


def cosine_with_warmup(base_lr: float, training_steps: int, warmup_steps: int = 0, num_cycles: float = 0.5,
                       min_fraction: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to ``min_fraction * base_lr``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(1, warmup_steps)
        progress = (step - warmup_steps) / max(1, training_steps - warmup_steps)
        cosine = 0.5 * (1.0 - min_fraction) * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * (min_fraction + max(0.0, cosine))

    return schedule


def constant_with_warmup(base_lr: float, warmup_steps: int = 0) -> Schedule:
    """Linear warmup then constant."""

    def schedule(step: int) -> float:
        return base_lr * min(1.0, step / max(1, warmup_steps))

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


class Optimizer:
    """Global-norm clip + AdamW + LR schedule over one parameter list (see
    the module docstring). ``step()`` applies one update from the
    parameters' ``.grad``; a parameter without one is updated as with a zero
    gradient, as optax does."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule, weight_decay: float,
                 betas, gradient_clip: Optional[float]):
        self.params = list(params)
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        self.count = 0  # applied updates: the schedule's index
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=betas, eps=1e-8,
                                       weight_decay=weight_decay)

    def grads(self) -> List[torch.Tensor]:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> None:
        grads = self.grads()
        if self.gradient_clip is not None:
            clip_by_global_norm_(grads, self.gradient_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(learning_rate: Union[float, Schedule], optimizer: str = "adamw", weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999,
                   gradient_clip: Optional[float] = None) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """A factory ``tx(params) -> Optimizer`` (``TrainState.create`` calls
    it): the port's ``make_optimizer("adamw", gradient_clip=...,
    weight_decay=...)``. Only AdamW with f32 moments is ported."""
    if optimizer != "adamw":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported (only 'adamw')")
    schedule = learning_rate if callable(learning_rate) else (lambda step, lr=float(learning_rate): lr)

    def tx(params: Iterable[torch.nn.Parameter]) -> Optimizer:
        return Optimizer(params, schedule, weight_decay, (beta1, beta2), gradient_clip)

    return tx
