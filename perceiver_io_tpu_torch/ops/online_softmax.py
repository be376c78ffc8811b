"""Blockwise (online) softmax-attention primitives (counterpart of
``perceiver_io_tpu/ops/online_softmax.py``).

The exact-decomposition core of the sequence-parallel paths
(``parallel.ring_attention``, ``core.modules.PerceiverAR.seq_parallel_forward``):
attention over a partitioned key/value axis is computed per block and the
partial results are combined with a log-sum-exp reduction, numerically dense
softmax attention up to float error, without the full score matrix on one
device.

All statistics are f32 whatever the input dtype. The JAX package computes
these blocks with plain einsums, outside any Pallas kernel, so the port's are
plain ``torch.matmul``.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, masked: torch.Tensor):
    """One attention block with running-softmax statistics.

    q: (B, H, N, Dk), k: (B, H, M, Dk), v: (B, H, M, Dv), any dtype;
    masked: bool broadcastable to (B, 1|H, N, M), True = masked out.

    Returns (o, m, l) in f32: the un-normalized output ``o`` (B, H, N, Dv),
    the row maxima ``m`` and the row sums ``l`` (B, H, N). A fully masked row
    gives o = 0, l = 0 and m at the -inf surrogate, which combine correctly.
    ``m`` carries no gradient (the JAX package's ``stop_gradient``): o / l is
    shift-invariant in m."""
    # f32 scores from any input dtype (JAX's preferred_element_type=f32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).masked_fill(masked, NEG_INF)
    m = s.amax(dim=-1).detach()
    # guard fully masked rows: exp(NEG_INF - NEG_INF) would be exp(0) = 1
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None]).masked_fill(masked, 0.0)
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype), v).float()
    return o, m, l


def online_combine(acc, new):
    """Combine two (o, m, l) partial-softmax states into one."""
    o_a, m_a, l_a = acc
    o_n, m_n, l_n = new
    m = torch.maximum(m_a, m_n)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    s_a = torch.exp(m_a - m_safe)
    s_n = torch.exp(m_n - m_safe)
    return o_a * s_a[..., None] + o_n * s_n[..., None], m, l_a * s_a + l_n * s_n


def finalize(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Normalize an accumulated output; fully masked rows return 0."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / l_safe[..., None]
