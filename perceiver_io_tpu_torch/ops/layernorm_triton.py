"""K1: the LayerNorm forward as a Triton kernel (source module).

Replaces the TPU kernel ``perceiver_io_tpu/ops/layernorm.py::_fwd_kernel``
(reached from ``_ln2d_fwd_impl`` via ``layer_norm``): one pass over each row,
f32 sum and sum of squares, ``var = max(E[x^2] - E[x]^2, 0)``, ``rsqrt(var +
eps)``, the affine, and a cast of ``y`` only.

What bounds it: a row reduction plus one elementwise pass, about 2 FLOP per
byte, so memory bytes (each input row read once, each output row written
once). A program normalizes ``BLOCK_R`` rows held whole in registers
(``C = 512`` is one tile), so x is read from device memory exactly once.

This module imports Triton at the top and is therefore imported only by
``ops/layernorm.py`` when it launches on a CUDA tensor; the machine without a
card has no Triton.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl


# n_rows varies with every prompt length: not specializing on it keeps one
# compiled kernel per (dtype, C) instead of one per divisibility class
@triton.jit(do_not_specialize=["n_rows"])
def _layer_norm_fwd_kernel(
    x_ptr, w_ptr, b_ptr, y_ptr, n_rows, n_cols, eps,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / n_cols
    mean2 = tl.sum(x * x, axis=1) / n_cols
    var = tl.maximum(mean2 - mean * mean, 0.0)
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    y = (x - mean[:, None]) * rstd[:, None] * w[None, :] + b[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


def launch_layer_norm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, y: torch.Tensor, eps: float) -> None:
    """``x``/``y`` (rows, C) contiguous on one CUDA device; ``w``/``b`` (C,)."""
    n_rows, n_cols = x.shape
    block_c = triton.next_power_of_2(n_cols)
    block_r = max(1, min(16, 4096 // block_c))
    grid = (triton.cdiv(n_rows, block_r),)
    with torch.cuda.device(x.device):
        _layer_norm_fwd_kernel[grid](
            x, w, b, y, n_rows, n_cols, eps,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
