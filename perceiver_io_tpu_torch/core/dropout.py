"""Dropout as Flax's ``nn.Dropout`` computes it (the JAX package's attention
and residual dropout): ``where(keep, x / (1 - rate), 0)`` with ``keep ~
Bernoulli(1 - rate)``, zeros at ``rate == 1``, the input itself at ``rate ==
0`` or in a deterministic forward.

The keep masks are drawn apart from their use. A layer draws all of its masks
when it is entered, in a fixed order (the attention probabilities, then the
attention residual, then the MLP residual), from the forward's
``torch.Generator``, and hands them to its body. So a layer whose body is
recomputed in the backward (``core.remat``) recomputes it with the masks of the
first forward, whatever the generator did in between, on the CPU and inside a
captured CUDA graph alike; and the draws, and so the numbers, are the same
with and without recomputation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def keep_mask(owner: nn.Module, site: int, shape: Sequence[int], rate: float,
              generator: Optional[torch.Generator], device) -> Optional[torch.Tensor]:
    """The bool keep mask of dropout site ``site`` of ``owner`` (the module
    whose dropout it is: a layer for its residual branches, in call order, a
    ``MultiHeadAttention`` for its probabilities), ``uniform < 1 - rate``
    from ``generator`` (the device's default generator when None). None where
    the rate is 0 (nothing is drawn); all False, drawn from nothing, at rate
    1. ``owner`` and ``site`` name the draw for callers that supply their own
    masks."""
    if rate == 0.0:
        return None
    if rate == 1.0:
        return torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    return torch.rand(tuple(shape), generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``x`` with ``keep``'s dropout applied (``x`` itself when ``keep`` is
    None); at ``rate == 1`` zeros that carry no gradient, as Flax returns."""
    if keep is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
