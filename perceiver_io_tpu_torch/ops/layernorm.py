"""LayerNorm forward (K1) and its plain PyTorch version.

Counterpart of ``perceiver_io_tpu/ops/layernorm.py`` (forward; the backward
comes with the training slice). The formula is flax's fast-variance LayerNorm
as the JAX package computes it: f32 statistics of the unrounded input,
``var = max(E[x^2] - E[x]^2, 0)``, ``rsqrt(var + eps)``, the affine in f32, and
only ``y`` cast to the output dtype. That differs from
``torch.nn.functional.layer_norm`` (two-pass variance), which the port does
not use.

Dispatch is by device: a CUDA tensor launches the Triton kernel in
``ops/layernorm_triton.py`` (or raises), a CPU tensor takes
:func:`layer_norm_reference`.
"""

from __future__ import annotations

import torch
from torch import nn

from perceiver_io_tpu_torch.ops import build


def layer_norm_reference(x, weight, bias, eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """The plain version (``_reference_ln`` of the JAX package)."""
    dtype = dtype or x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(dtype)


def _layer_norm_cuda(x, weight, bias, eps, dtype):
    from perceiver_io_tpu_torch.ops.layernorm_triton import launch_layer_norm_fwd

    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},), got {tuple(weight.shape)}/{tuple(bias.shape)}")
    if not (weight.is_cuda and bias.is_cuda and weight.device == x.device and bias.device == x.device):
        raise ValueError("x, weight and bias must lie on one CUDA device")
    x2 = x.reshape(-1, c).contiguous()
    y = torch.empty(x2.shape, dtype=dtype, device=x.device)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    launch_layer_norm_fwd(x2, weight.contiguous(), bias.contiguous(), y, float(eps))
    build.count_launch("layer_norm_fwd")
    return y.reshape(x.shape)


def layer_norm(x, weight, bias, eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis; Triton kernel for CUDA tensors."""
    dtype = dtype or x.dtype
    if x.is_cuda:
        return _layer_norm_cuda(x, weight, bias, eps, dtype)
    return layer_norm_reference(x, weight, bias, eps, dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm with f32 ``weight``/``bias`` (the reference torch names of
    flax's ``scale``/``bias``), backed by :func:`layer_norm`."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
