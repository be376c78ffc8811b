"""K1 (LayerNorm forward) and K5 (LayerNorm backward) as Triton kernels
(source module).

K1 replaces the TPU kernel ``perceiver_io_tpu/ops/layernorm.py::_fwd_kernel``
(reached from ``_ln2d_fwd_impl`` via ``layer_norm``): one pass over each row,
f32 sum and sum of squares, ``var = max(E[x^2] - E[x]^2, 0)``, ``rstd =
rsqrt(var + eps)``, the affine, and a cast of ``y`` only. Its ``WANT_STATS``
variant (the JAX ``want_stats``) also writes the per-row f32 ``mean`` and
``rstd`` the backward reads; the serving path launches it without them.

K5 replaces ``_bwd_kernel`` (reached from ``_ln2d_bwd``): with ``xhat = (x -
mean) * rstd`` and ``g = dy * gamma``, ``dx = rstd * (g - mean(g) - xhat *
mean(g * xhat))`` per row, and the column sums ``dgamma = sum(dy * xhat)``,
``dbeta = sum(dy)``. The TPU kernel carries the column sums across its
sequential grid in scratch; Hopper runs programs in no order, so each program
of the first pass walks a fixed run of rows and writes f32 partial
``dgamma``/``dbeta`` rows, and a second pass sums the partials in a fixed
order: deterministic, no atomics.

What bounds them: row reductions plus elementwise passes, a few FLOP per
byte, so memory bytes (each input row read once, each output row written
once). A program holds ``BLOCK_R`` rows of ``C`` in registers, so x and dy
are read from device memory exactly once. K5's first pass takes its
partition from ``ops/layernorm.py::layer_norm_bwd_partition``: one
program an SM, each over one contiguous run of whole row blocks, the next
blocks' loads in flight while a block computes (``tl.range`` stages), so the
grid is one wave and the loads never wait on the arithmetic. Its second pass
gives each program ``REDUCE_COLS`` columns (128 programs at C = 1024), so
the partial rows, written just before and read from L2, are summed on many
SMs at once rather than walked serially by ``C / 128`` of them.

This module imports Triton at the top and is therefore imported only by
``ops/layernorm.py`` when it launches on a CUDA tensor; the machine without a
card has no Triton.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl

from perceiver_io_tpu_torch.ops.layernorm import layer_norm_bwd_partition, row_block

# K5's second pass: each program sums REDUCE_COLS columns of the partial
# rows, REDUCE_ROWS rows a step (128 programs at C = 1024, 64 at 512)
REDUCE_ROWS, REDUCE_COLS = 128, 8


# n_rows varies with every prompt length: not specializing on it keeps one
# compiled kernel per (dtype, C) instead of one per divisibility class
@triton.jit(do_not_specialize=["n_rows"])
def _layer_norm_fwd_kernel(
    x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, n_rows, n_cols, eps,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr, WANT_STATS: tl.constexpr,
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
    if WANT_STATS:
        tl.store(mean_ptr + rows, mean, mask=rows < n_rows)
        tl.store(rstd_ptr + rows, rstd, mask=rows < n_rows)


@triton.jit(do_not_specialize=["n_rows", "rows_per_prog"])
def _layer_norm_bwd_dx_kernel(
    x_ptr, w_ptr, mean_ptr, rstd_ptr, dy_ptr, dx_ptr, dw_part_ptr, db_part_ptr,
    n_rows, n_cols, rows_per_prog,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    dw_acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
    db_acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
    start = pid * rows_per_prog
    end = tl.minimum(start + rows_per_prog, n_rows)
    # the next two blocks' loads fly while a block computes
    for r0 in tl.range(start, end, BLOCK_R, num_stages=3):
        rows = r0 + tl.arange(0, BLOCK_R)
        rmask = rows < end
        mask = rmask[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + rows, mask=rmask, other=0.0)
        rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
        xhat = tl.where(mask, (x - mean[:, None]) * rstd[:, None], 0.0)
        g = dy * w[None, :]
        m1 = tl.sum(g, axis=1) / n_cols
        m2 = tl.sum(g * xhat, axis=1) / n_cols
        dx = rstd[:, None] * (g - m1[:, None] - xhat * m2[:, None])
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        dw_acc += tl.sum(dy * xhat, axis=0)
        db_acc += tl.sum(dy, axis=0)
    tl.store(dw_part_ptr + pid * n_cols + cols, dw_acc, mask=cmask)
    tl.store(db_part_ptr + pid * n_cols + cols, db_acc, mask=cmask)


@triton.jit
def _layer_norm_bwd_dwdb_kernel(
    dw_part_ptr, db_part_ptr, dw_ptr, db_ptr, n_parts, n_cols,
    BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    dw = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    db = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    for p0 in tl.range(0, n_parts, BLOCK_P, num_stages=2):
        parts = p0 + tl.arange(0, BLOCK_P)
        mask = (parts < n_parts)[:, None] & cmask[None, :]
        offs = parts[:, None] * n_cols + cols[None, :]
        dw += tl.load(dw_part_ptr + offs, mask=mask, other=0.0)
        db += tl.load(db_part_ptr + offs, mask=mask, other=0.0)
    tl.store(dw_ptr + cols, tl.sum(dw, axis=0), mask=cmask)
    tl.store(db_ptr + cols, tl.sum(db, axis=0), mask=cmask)


def launch_layer_norm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, y: torch.Tensor, eps: float,
                          mean: torch.Tensor = None, rstd: torch.Tensor = None) -> None:
    """``x``/``y`` (rows, C) contiguous on one CUDA device; ``w``/``b`` (C,);
    ``mean``/``rstd`` (rows,) f32 to receive the statistics, or None."""
    n_rows, n_cols = x.shape
    block_r, block_c = row_block(n_cols)
    want_stats = mean is not None
    grid = (triton.cdiv(n_rows, block_r),)
    with torch.cuda.device(x.device):
        _layer_norm_fwd_kernel[grid](
            x, w, b, y, mean if want_stats else y, rstd if want_stats else y, n_rows, n_cols, eps,
            BLOCK_R=block_r, BLOCK_C=block_c, WANT_STATS=want_stats, num_warps=4,
        )


def launch_layer_norm_bwd_dx(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                             dy: torch.Tensor, dx: torch.Tensor):
    """K5's first pass: writes ``dx`` and returns the f32 partial
    ``dgamma``/``dbeta`` rows (programs, C), one a program, for
    :func:`launch_layer_norm_bwd_dwdb`. Operands as
    :func:`launch_layer_norm_bwd` takes them."""
    n_rows, n_cols = x.shape
    block_r, rows_per_prog, n_progs = layer_norm_bwd_partition(
        n_rows, n_cols, torch.cuda.get_device_properties(x.device).multi_processor_count)
    dw_part = torch.empty((n_progs, n_cols), dtype=torch.float32, device=x.device)
    db_part = torch.empty((n_progs, n_cols), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _layer_norm_bwd_dx_kernel[(n_progs,)](
            x, w, mean, rstd, dy, dx, dw_part, db_part, n_rows, n_cols, rows_per_prog,
            BLOCK_R=block_r, BLOCK_C=row_block(n_cols)[1], num_warps=4,
        )
    return dw_part, db_part


def launch_layer_norm_bwd_dwdb(dw_part: torch.Tensor, db_part: torch.Tensor, dw: torch.Tensor,
                               db: torch.Tensor) -> None:
    """K5's second pass: ``dw``/``db`` (C,) f32, each column the sum of its
    partial rows in row order, ``REDUCE_COLS`` columns a program."""
    n_parts, n_cols = dw_part.shape
    with torch.cuda.device(dw_part.device):
        _layer_norm_bwd_dwdb_kernel[(triton.cdiv(n_cols, REDUCE_COLS),)](
            dw_part, db_part, dw, db, n_parts, n_cols, BLOCK_P=REDUCE_ROWS, BLOCK_C=REDUCE_COLS, num_warps=4,
        )


def launch_layer_norm_bwd(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                          dy: torch.Tensor, dx: torch.Tensor, dw: torch.Tensor, db: torch.Tensor) -> None:
    """``x``/``dy``/``dx`` (rows, C) contiguous on one CUDA device, ``w``
    (C,), ``mean``/``rstd`` (rows,) f32 from K1; writes ``dx`` and the f32
    ``dw``/``db`` (C,): the two passes."""
    launch_layer_norm_bwd_dwdb(*launch_layer_norm_bwd_dx(x, w, mean, rstd, dy, dx), dw, db)
