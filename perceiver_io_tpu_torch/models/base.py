"""The construction steps the port's Perceiver IO task models share: where
to build them (a meta model holds no data) and their seeded initialization."""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.core.modules import init_normal_
from perceiver_io_tpu_torch.device import DeviceLike, resolve_device


def building_on(device: DeviceLike):
    """``(device, context)`` for a task model's constructor: the resolved
    ``device`` (``"meta"`` allowed) and the context to build the modules in
    (``torch.device("meta")`` for a meta model, whose parameters hold no
    data, so a full-size model is counted without its memory)."""
    dev = resolve_device(device, allow_meta=True)
    return dev, (torch.device("meta") if dev.type == "meta" else contextlib.nullcontext())


def finish_model(model: nn.Module, dev: torch.device, parts: Sequence[Tuple[nn.Module, float]],
                 generator: Optional[torch.Generator]) -> None:
    """Initialize ``model``'s weights (:func:`core.modules.init_normal_`,
    drawn on the CPU from ``generator``, seeded 0 when None, so one seed
    gives the same model on every device), move it to ``dev`` and set it to
    eval mode. A meta model is left without data."""
    if dev.type != "meta":
        init_normal_(parts, generator if generator is not None else torch.Generator().manual_seed(0))
        model.to(dev)
    model.eval()
