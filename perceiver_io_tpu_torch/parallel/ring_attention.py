"""Sequence/context parallelism: ring attention and sequence-sharded
cross-attention over the ``seq`` mesh axis (counterpart of
``perceiver_io_tpu/parallel/ring_attention.py``).

Two exact primitives (dense softmax attention up to float error):

- :func:`seq_sharded_cross_attention`: queries replicated (Perceiver AR's
  latents), keys and values sharded along ``seq``. Each rank attends its
  local block, then the partials are combined with a log-sum-exp reduction:
  one ``all_reduce(MAX)`` of the detached row maxima and two
  ``all_reduce(SUM)`` (O(latents) communication, whatever the context
  length).
- :func:`ring_self_attention`: queries and keys/values sharded. The key and
  value blocks travel around the ring (``batch_isend_irecv`` to rank
  ``(i + 1) % n``) while each rank folds every visiting block into its query
  block's online softmax (Ring Attention, Liu et al., arXiv:2310.01889).

Both take this rank's blocks and the ``seq`` process group (the JAX
functions run inside ``shard_map`` with an axis name); JAX's collectives
become ``torch.distributed``'s: ``pmax`` an ``all_reduce(MAX)`` on the
detached statistic, ``psum`` an ``all_reduce(SUM)`` whose backward is an
``all_reduce(SUM)`` (the transpose of ``psum``), ``ppermute`` a send to the
next rank whose backward sends the gradient back. The block products are
plain ``torch.matmul`` (``ops.online_softmax``), as the JAX package's are
plain einsums.

:func:`make_ring_cross_attention` / :func:`make_ring_self_attention` build
whole-array wrappers: they take the global arrays, slice out this rank's
block and return what JAX's ``out_specs`` give (the replicated output for
the cross-attention, this rank's block for the self-attention).

Masking follows the core attention contract: ``pad_mask`` is True at masked
key positions; the causal mask is right-aligned when the query length
differs from the total key length.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from perceiver_io_tpu_torch.ops.online_softmax import NEG_INF, block_attention, finalize, online_combine
from perceiver_io_tpu_torch.parallel.mesh import AXIS_SEQ, axis_group


class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over the group, whose backward is the sum of the
    upstream gradients over the group (the transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum over the group, without a gradient (JAX's ``pmax`` has no
    differentiation rule; callers pass detached statistics)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on along the group's ring and
    receive the one from ``step`` places back."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    out = torch.empty_like(x)
    x = x.contiguous()
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """``ppermute`` to rank ``(i + 1) % n``; its backward sends the gradient
    back to ``(i - 1) % n``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def seq_sharded_cross_attention(q, k_local, v_local, pad_mask_local=None, *, group, causal: bool = False,
                                kv_len_total: Optional[int] = None, finalize_output: bool = True):
    """Cross-attention with replicated queries and keys/values sharded over
    ``group`` (the mesh's ``seq`` group).

    q: (B, H, N, Dk) replicated (pre-scaled, pre-rotated);
    k_local/v_local: (B, H, M_local, Dk|Dv), this rank's block;
    pad_mask_local: (B, M_local) True = masked, or None;
    causal: right-aligned causal mask over GLOBAL key positions (query i at
    ``kv_len_total - N + i``).
    Returns the normalized output (B, H, N, Dv) in f32, the same on every
    rank, or with ``finalize_output=False`` the un-normalized partial
    ``(o, m, l)`` (the JAX function's ``finalize=False``), which
    ``PerceiverAR.seq_parallel_forward`` merges with its causal latent
    partial."""
    idx, n_dev = dist.get_rank(group), dist.get_world_size(group)
    m_local = k_local.shape[2]
    if kv_len_total is None:
        kv_len_total = m_local * n_dev
    dev = q.device
    masked = torch.zeros((1, 1, 1, m_local), dtype=torch.bool, device=dev)
    if pad_mask_local is not None:
        masked = masked | pad_mask_local[:, None, None, :].to(dev)
    if causal:
        n_q = q.shape[2]
        kv_global = idx * m_local + torch.arange(m_local, device=dev)
        q_abs = kv_len_total - n_q + torch.arange(n_q, device=dev)
        masked = masked | (kv_global[None, None, None, :] > q_abs[None, None, :, None])
    o, m, l = block_attention(q, k_local, v_local, masked)
    # the log-sum-exp combine across the group: O(N) communication
    m_glob = pmax(m, group)
    scale = torch.exp(m - torch.clamp(m_glob, min=NEG_INF / 2))
    o = psum(o * scale[..., None], group)
    l = psum(l * scale, group)
    if not finalize_output:
        return o, m_glob, l
    return finalize(o, l)


def ring_self_attention(q_local, k_local, v_local, pad_mask_local=None, *, group, causal: bool = False):
    """Ring attention: queries and keys/values sharded over ``group``.

    q_local: (B, H, N_local, Dk), this rank's query block (pre-scaled);
    k_local/v_local: (B, H, M_local, ·); pad_mask_local: (B, M_local) True
    = masked, or None. The key/value blocks and their masks travel the ring;
    with ``causal=True`` blocks wholly in the future are masked, not skipped
    (every rank runs the same steps). Returns this rank's output block
    (B, H, N_local, Dv) in f32."""
    n_dev, idx = dist.get_world_size(group), dist.get_rank(group)
    n_q, m_local = q_local.shape[2], k_local.shape[2]
    dev = q_local.device
    # right-aligned query positions: query i sits at kv_total - q_total + i
    right_shift = (m_local - n_q) * n_dev
    q_global = right_shift + idx * n_q + torch.arange(n_q, device=dev)
    o = torch.zeros(q_local.shape[:3] + (v_local.shape[3],), dtype=torch.float32, device=dev)
    m = torch.full(q_local.shape[:3], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q_local.shape[:3], dtype=torch.float32, device=dev)
    k_blk, v_blk, pm_blk = k_local, v_local, pad_mask_local
    for step in range(n_dev):
        src = (idx - step) % n_dev  # whose block this rank holds now
        kv_global = src * m_local + torch.arange(m_local, device=dev)
        masked = torch.zeros((1, 1, 1, m_local), dtype=torch.bool, device=dev)
        if pm_blk is not None:
            masked = masked | pm_blk[:, None, None, :]
        if causal:
            masked = masked | (kv_global[None, None, None, :] > q_global[None, None, :, None])
        o, m, l = online_combine((o, m, l), block_attention(q_local, k_blk, v_blk, masked))
        if step + 1 < n_dev:
            k_blk, v_blk = _RingShift.apply(k_blk, group), _RingShift.apply(v_blk, group)
            if pm_blk is not None:
                pm_blk = _shift(pm_blk.to(torch.uint8), group, 1).bool()
    return finalize(o, l)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (which must divide)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n != 0:
        raise ValueError(f"length {x.shape[dim]} is not divisible by the seq axis ({n})")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def make_ring_cross_attention(mesh, *, causal: bool = False, kv_len_total: Optional[int] = None):
    """Whole-array wrapper ``attend(q, k, v, pad_mask=None)``: q (B, H, N, D)
    replicated, k/v (B, H, M, D) and pad_mask (B, M) global, sliced to this
    rank's block along M over the mesh's ``seq`` axis. Returns the
    replicated output."""
    group = axis_group(mesh, AXIS_SEQ)

    def attend(q, k, v, pad_mask=None):
        pm = None if pad_mask is None else _block(pad_mask, 1, group)
        return seq_sharded_cross_attention(q, _block(k, 2, group), _block(v, 2, group), pm, group=group,
                                           causal=causal, kv_len_total=kv_len_total)

    return attend


def make_ring_self_attention(mesh, *, causal: bool = False):
    """Whole-array wrapper ``attend(q, k, v, pad_mask=None)``: q, k, v
    (B, H, N, D) and pad_mask (B, N) global, each sliced to this rank's block
    along its length axis over the mesh's ``seq`` axis. Returns this rank's
    output block (JAX's ``out_specs``: sharded along ``seq``)."""
    group = axis_group(mesh, AXIS_SEQ)

    def attend(q, k, v, pad_mask=None):
        pm = None if pad_mask is None else _block(pad_mask, 1, group)
        return ring_self_attention(_block(q, 2, group), _block(k, 2, group), _block(v, 2, group), pm,
                                   group=group, causal=causal)

    return attend
