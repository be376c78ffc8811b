"""Packed flash attention forward (K2) and its plain PyTorch version.

Counterpart of ``perceiver_io_tpu/ops/flash_attention.py::flash_attention_packed``
(forward only; the backward comes with the training slice). Operands stay in
the projection layout ``(B, N, H*D)``: a head is a strided column slice.

Semantics (shared by the CUDA kernel ``csrc/flash_packed.cu`` and
:func:`flash_attention_packed_reference`):

- scores ``s_ij = sm_scale * q_i . k_j + bias_j`` in f32, where the bias row is
  0 or the finite ``MASK_VALUE`` at padded keys;
- ``causal``: right-aligned, query ``i`` sees key ``j`` iff
  ``j <= i + (Nkv - Nq)`` from the unpadded lengths; keys past that limit
  never enter the softmax;
- a row whose visible keys are all padded gets the uniform average of those
  keys' values (finite mask value: not zero, not NaN); a row that sees no key
  at all (only when ``Nq > Nkv``) gets 0 and logsumexp ``-inf``;
- output in q's dtype, logsumexp ``(B, Nq, H)`` f32.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version. There is no fallback on failure.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from perceiver_io_tpu_torch.ops import build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def packed_supported(num_heads: int, d_qk: int, d_v: int) -> bool:
    """Head dims the kernel takes: multiples of 8 up to 128."""
    return num_heads >= 1 and all(d % 8 == 0 and 8 <= d <= 128 for d in (d_qk, d_v))


def _bias_row(pad_mask: Optional[torch.Tensor], b: int, nkv: int, device) -> Optional[torch.Tensor]:
    if pad_mask is None:
        return None
    if pad_mask.shape != (b, nkv):
        raise ValueError(f"pad_mask must be {(b, nkv)}, got {tuple(pad_mask.shape)}")
    return torch.zeros((b, nkv), dtype=torch.float32, device=device).masked_fill_(pad_mask.to(device), MASK_VALUE)


def flash_attention_packed_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a masked dense f32 softmax. Returns ``(o, lse)``."""
    b, nq, cq = q.shape
    nkv = k.shape[1]
    h = num_heads
    d_qk, d_v = cq // h, v.shape[2] // h
    q4 = q.float().reshape(b, nq, h, d_qk)
    k4 = k.float().reshape(b, nkv, h, d_qk)
    v4 = v.float().reshape(b, nkv, h, d_v)
    s = torch.einsum("bihc,bjhc->bhij", q4, k4) * sm_scale
    bias = _bias_row(pad_mask, b, nkv, q.device)
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        i = torch.arange(nq, device=q.device)[:, None]
        j = torch.arange(nkv, device=q.device)[None, :]
        s = s.masked_fill(j > i + (nkv - nq), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_use = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_use)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhij,bjhc->bihc", p, v4) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)  # (B, Nq, H)
    return o.reshape(b, nq, h * d_v).to(q.dtype), lse.contiguous()


def _flash_packed_cuda(q, k, v, num_heads, pad_mask, causal, sm_scale):
    b, nq, cq = q.shape
    nkv = k.shape[1]
    h = num_heads
    d_qk, d_v = cq // h, v.shape[2] // h
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_packed takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.is_cuda and v.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if not packed_supported(h, d_qk, d_v):
        raise ValueError(f"head dims ({d_qk}, {d_v}) must be multiples of 8 up to 128")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = _bias_row(pad_mask, b, nkv, q.device)
    o = torch.empty((b, nq, h * d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    err = build.launcher("flash_packed")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        b, nq, nkv, h, d_qk, d_v, int(bool(causal)), float(sm_scale),
        _DTYPE_CODES[q.dtype], build.current_stream(q.device),
    )
    build.check(err, "flash_packed_fwd")
    build.count_launch("flash_packed_fwd")
    return o, lse


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
    return_lse: bool = False,
):
    """Fused attention over packed ``(B, N, H*D)`` tensors.

    :param q: queries (B, Nq, H*Dqk), already scaled/rotated.
    :param k: keys (B, Nkv, H*Dqk), already rotated.
    :param v: values (B, Nkv, H*Dv).
    :param pad_mask: (B, Nkv) bool, True at padded keys.
    :returns: (B, Nq, H*Dv) in q's dtype, and the (B, Nq, H) f32 logsumexp
        when ``return_lse``.
    """
    if q.is_cuda:
        o, lse = _flash_packed_cuda(q, k, v, num_heads, pad_mask, causal, sm_scale)
    else:
        o, lse = flash_attention_packed_reference(q, k, v, num_heads, pad_mask, causal, sm_scale)
    return (o, lse) if return_lse else o
