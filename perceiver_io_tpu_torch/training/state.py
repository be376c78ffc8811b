"""The train state (counterpart of ``perceiver_io_tpu/training/state.py``).

PyTorch keeps parameters and optimizer moments in mutable objects, so the
state holds them instead of a pytree: the model, its :class:`Optimizer` (the
``make_optimizer`` chain), the step counter (calls, as the JAX package counts
them), the generator of the training
forwards' random draws, and the mesh a sharded state lives on. The train step
updates it in place and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch

from perceiver_io_tpu_torch.training.optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None
    # the DeviceMesh the state is sharded over (training.loop.shard_train_state)
    mesh: Optional[object] = None
    # on a mesh: {parameter name: (tensor dim, fsdp dim)}, JAX's placement of
    # each parameter (parallel.mesh.param_shardings; checkpoint fingerprints
    # read it), and the model's unsharded skeleton (meta parameters) that a
    # placement on another mesh rebuilds it from
    placement: Optional[dict] = None
    template: Optional[torch.nn.Module] = None

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Callable[[Iterable[torch.nn.Parameter]], Optimizer],
               generator: Optional[torch.Generator] = None) -> "TrainState":
        """``tx`` from ``make_optimizer`` (given the model's named
        parameters, which a frozen mask reads); ``generator`` draws the keep
        sets of batches that carry none and the dropout masks (it must live
        on the model's device)."""
        return cls(model=model, optimizer=tx(model.named_parameters()), generator=generator)

    def apply_gradients(self) -> None:
        """One optimizer call from the parameters' ``.grad`` (an update, or
        with accumulation a mini-step); the step advances."""
        self.optimizer.step()
        self.step += 1
