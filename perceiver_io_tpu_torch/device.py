"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda", allow_meta: bool = False) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument. Asking for
    CUDA on a machine without a usable card raises: the port never drops to
    the CPU unless the caller asks for it with ``device="cpu"``. With
    ``allow_meta`` a model builder also takes ``"meta"`` (shapes without
    data: a parameter count)."""
    dev = torch.device(device)
    if allow_meta and dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: the port runs on 'cuda' or 'cpu'")
    return dev


def check_same_device(expected: torch.device, actual: torch.device, what: str) -> None:
    """Raise when an entry point's ``device=`` and its model disagree."""
    if expected.type != actual.type or (
        expected.index is not None and actual.index is not None and expected.index != actual.index
    ):
        raise ValueError(f"{what} lies on {actual}, but device={expected} was requested")
