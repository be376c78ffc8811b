"""LayerNorm: the forward (K1), the backward (K5) and their plain PyTorch
versions, joined by a ``torch.autograd.Function``.

Counterpart of ``perceiver_io_tpu/ops/layernorm.py`` (``layer_norm`` and the
custom VJP of ``_ln2d``). The formula is flax's fast-variance LayerNorm as the
JAX package computes it: f32 statistics of the unrounded input, ``var =
max(E[x^2] - E[x]^2, 0)``, ``rsqrt(var + eps)``, the affine in f32, and only
``y`` cast to the output dtype. That differs from
``torch.nn.functional.layer_norm`` (two-pass variance), which the port does
not use. The backward is the JAX ``_bwd_kernel``'s: from the forward's f32
``mean``/``rstd`` per row, ``dx`` in x's dtype and f32 ``dgamma``/``dbeta``.

Dispatch is by device: a CUDA tensor launches the Triton kernels in
``ops/layernorm_triton.py`` (or raises), a CPU tensor takes the plain
versions. Under grad mode, with an input that requires grad, the call goes
through :class:`_LayerNorm`, whose forward launches K1 with its statistics
and whose backward dispatches the same way; otherwise (serving) K1 runs
without them.
"""

from __future__ import annotations

import torch
from torch import nn

from perceiver_io_tpu_torch.ops import build


def _acc(t: torch.Tensor, like: torch.Tensor = None) -> torch.Tensor:
    """``t`` in the plain versions' arithmetic: f32, or f64 where ``like``
    (``t`` itself by default) is f64."""
    like = t if like is None else like
    return t.double() if like.dtype == torch.float64 else t.float()


def layer_norm_reference_stats(x, weight, bias, eps, dtype):
    """The plain forward with its statistics: ``(y, mean, rstd)``, the
    statistics (rows,) f32 (what K1's ``WANT_STATS`` variant writes; f64
    for f64 copies, which evaluate in f64)."""
    xf = _acc(x)
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    y = y * _acc(weight, x) + _acc(bias, x)
    return y.to(dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_reference(x, weight, bias, eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """The plain forward (``_reference_ln`` of the JAX package)."""
    return layer_norm_reference_stats(x, weight, bias, eps, dtype or x.dtype)[0]


def layer_norm_bwd_reference(x, weight, mean, rstd, dy):
    """The plain backward (what K5 computes, ``_bwd_kernel`` of the JAX
    package): ``(dx, dweight, dbias)`` from the forward's per-row ``mean`` /
    ``rstd`` (rows,) f32 and the output gradient ``dy``."""
    c = x.shape[-1]
    xf, dyf = _acc(x.reshape(-1, c)), _acc(dy.reshape(-1, c), x)
    rstd = rstd.reshape(-1, 1)
    xhat = (xf - mean.reshape(-1, 1)) * rstd
    g = dyf * _acc(weight, x)
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (g - m1 - xhat * m2)
    dw = (dyf * xhat).sum(dim=0)
    db = dyf.sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def row_block(n_cols: int) -> tuple:
    """``(block_r, block_c)``: the rows K1 and K5 hold at a time (up to 4096
    elements) and the power of two that covers a row."""
    block_c = 1 << max(0, n_cols - 1).bit_length()
    return max(1, min(16, 4096 // block_c)), block_c


# K5's first pass: programs an SM. One (4 warps, three row blocks in flight)
# ran both main-path shapes fastest on an H100 among 1, 2, 4 and 8 (PERF.md)
K5_PROGRAMS_PER_SM = 1


def layer_norm_bwd_partition(n_rows: int, n_cols: int, sms: int) -> tuple:
    """K5's first pass over ``n_rows`` rows of ``n_cols`` on ``sms`` SMs:
    ``(block_r, rows_per_prog, n_progs)``. A program holds ``block_r`` rows
    at a time (up to 4096 elements, as K1 does), and program ``p`` walks rows
    ``[p * rows_per_prog, min(n_rows, (p + 1) * rows_per_prog))``, whole
    blocks in order, so the programs' partial column sums cover every row
    once in a fixed grouping. At most ``K5_PROGRAMS_PER_SM * sms`` programs,
    and no empty one: 128 of 64 rows at 8192 x 1024 and 128 of 120 rows at
    15360 x 512, on 132 SMs."""
    block_r = row_block(n_cols)[0]
    n_blocks = max(1, -(-n_rows // block_r))
    rows_per_prog = block_r * -(-n_blocks // min(n_blocks, K5_PROGRAMS_PER_SM * sms))
    return block_r, rows_per_prog, -(-n_rows // rows_per_prog)


def _check_params(x, weight, bias) -> None:
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},), got {tuple(weight.shape)}/{tuple(bias.shape)}")
    if not (weight.is_cuda and bias.is_cuda and weight.device == x.device and bias.device == x.device):
        raise ValueError("x, weight and bias must lie on one CUDA device")


def layer_norm_cuda(x, weight, bias, eps, dtype, want_stats: bool = False):
    """The K1 wrapper: ``(y, mean, rstd)``; the statistics are None unless
    asked for."""
    from perceiver_io_tpu_torch.ops.layernorm_triton import launch_layer_norm_fwd

    _check_params(x, weight, bias)
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    y = torch.empty(x2.shape, dtype=dtype, device=x.device)
    mean = rstd = None
    if want_stats:
        mean = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    if x2.shape[0]:
        launch_layer_norm_fwd(x2, weight.contiguous(), bias.contiguous(), y, float(eps), mean, rstd)
        build.count_launch("layer_norm_fwd", x.dtype)
    return y.reshape(x.shape), mean, rstd


def layer_norm_bwd_cuda(x, weight, mean, rstd, dy):
    """The K5 wrapper: ``(dx, dweight, dbias)`` as
    :func:`layer_norm_bwd_reference` computes them."""
    from perceiver_io_tpu_torch.ops.layernorm_triton import launch_layer_norm_bwd

    c = x.shape[-1]
    if not (dy.device == x.device and weight.device == x.device):
        raise ValueError("x, dy and weight must lie on one CUDA device")
    x2, dy2 = x.reshape(-1, c).contiguous(), dy.reshape(-1, c).contiguous()
    dx = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    dw = torch.zeros(c, dtype=torch.float32, device=x.device)
    db = torch.zeros_like(dw)
    if x2.shape[0]:
        launch_layer_norm_bwd(x2, weight.contiguous(), mean, rstd, dy2, dx, dw, db)
        build.count_launch("layer_norm_bwd", x.dtype)
    return dx.reshape(x.shape), dw.to(weight.dtype), db.to(weight.dtype)


class _LayerNorm(torch.autograd.Function):
    """K1 with statistics forward, K5 backward on CUDA tensors; the plain
    versions on CPU tensors. Saves ``x``, ``weight`` and the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        if x.is_cuda:
            y, mean, rstd = layer_norm_cuda(x, weight, bias, eps, dtype, want_stats=True)
        else:
            y, mean, rstd = layer_norm_reference_stats(x, weight, bias, eps, dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd_cuda if dy.is_cuda else layer_norm_bwd_reference
        dx, dw, db = bwd(x, weight, mean, rstd, dy)
        return dx, dw, db, None, None


def layer_norm(x, weight, bias, eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis; Triton kernels for CUDA tensors.
    Differentiable in ``x``, ``weight`` and ``bias``."""
    dtype = dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps, dtype)
    if x.is_cuda:
        return layer_norm_cuda(x, weight, bias, eps, dtype)[0]
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
