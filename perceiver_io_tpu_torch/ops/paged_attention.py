"""Paged decode attention (K3) and its plain PyTorch version.

Counterpart of ``perceiver_io_tpu/ops/paged_attention.py``. One query per
decode slot attends over that slot's pages of a :class:`PagedKVCache` pool:
token ``t`` of slot ``s`` lives at ``(page_table[s, t // page], t % page)``.
Slot validity (``j >= length[s]`` is masked) always applies; an optional
``(S, capacity)`` bool mask (True = masked) adds the caller's left pads and
expired window slots. (The JAX function's ``mask`` replaces the validity
mask instead; its callers always include validity in it, so the results
agree.)

The CUDA kernel (``csrc/paged_decode.cu``, f32 pools) walks the page table
and reads each page straight from the pool, up to the slot's length;
:func:`paged_attention_reference` rebuilds the contiguous view with
``gather_view`` and runs dense attention. The two agree on every slot with
``length >= 1``; a slot with length 0 (retired, its output discarded by the
engine) gets 0 from the kernel and a uniform average from the reference.
Dispatch is by device, as in ``ops/flash_attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_tpu_torch.ops import build
from perceiver_io_tpu_torch.ops.flash_attention import MASK_VALUE


def paged_kernel_supported(cache, num_heads: int, d_qk: int, d_v: int) -> bool:
    """Whether the kernel serves this pool: f32 pools (the serving path's
    cache dtype) and head dims up to 128 (four channels per lane)."""
    return (cache.k.dtype == torch.float32 and cache.v.dtype == torch.float32
            and 1 <= d_qk <= 128 and 1 <= d_v <= 128)


def reference_kernel_geometry(cache, num_heads: int, d_qk: int, d_v: int) -> bool:
    """Whether the JAX package's page-walk kernel serves this geometry: its
    gate takes any float pool with pages of at least 8 rows whose packed
    head widths (H * D) are multiples of 128 lanes. Where it does not, the
    JAX package gathers, and so may the port."""
    return cache.page_size >= 8 and (num_heads * d_qk) % 128 == 0 and (num_heads * d_v) % 128 == 0


def paged_attention_reference(qh: torch.Tensor, cache, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: gather view + dense attention; softmax in f32, value
    product in the storage dtype. ``qh`` (S, H, Dk) -> (S, H, Dv)."""
    k_slots, v_slots = cache.gather_view()
    s_slots, cap = k_slots.shape[0], k_slots.shape[1]
    invalid = torch.arange(cap, device=cache.k.device)[None, :] >= cache.length[:, None]
    mask = invalid if mask is None else invalid | mask
    h, d_qk = qh.shape[1], qh.shape[2]
    d_v = cache.v.shape[2] // h
    k_h = k_slots.reshape(s_slots, cap, h, d_qk)
    v_h = v_slots.reshape(s_slots, cap, h, d_v)
    scores = torch.einsum("bhc,bjhc->bhj", qh.float(), k_h.float())
    scores = scores.masked_fill(mask[:, None, :], MASK_VALUE)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhj,bjhc->bhc", attn.to(v_h.dtype), v_h)


def _paged_decode_cuda(qh, cache, mask):
    s_slots, h, d_qk = qh.shape
    d_v = cache.v.shape[2] // h
    if qh.dtype != torch.float32 or cache.k.dtype != torch.float32 or cache.v.dtype != torch.float32:
        raise TypeError(f"paged_decode_attention takes f32 q and pools, got "
                        f"{qh.dtype}/{cache.k.dtype}/{cache.v.dtype}")
    if d_qk > 128 or d_v > 128:
        raise ValueError(f"paged decode kernel takes head dims <= 128, got ({d_qk}, {d_v})")
    dev = qh.device
    for t in (cache.k, cache.v, cache.page_table, cache.length):
        if t.device != dev:
            raise ValueError("query, pools, page table and lengths must lie on one CUDA device")
    if cache.k.shape[2] != h * d_qk:
        raise ValueError(f"query heads {h}x{d_qk} do not match the K pool width {cache.k.shape[2]}")
    bias = None
    if mask is not None:
        if mask.shape != (s_slots, cache.capacity):
            raise ValueError(f"mask must be {(s_slots, cache.capacity)}, got {tuple(mask.shape)}")
        bias = torch.where(mask, MASK_VALUE, 0.0).to(torch.float32)
    q = qh.reshape(s_slots, h * d_qk).contiguous()
    table = cache.page_table.to(torch.int32).contiguous()
    length = cache.length.to(torch.int32).contiguous()
    k_pool, v_pool = cache.k.contiguous(), cache.v.contiguous()
    # split the page walk so about four CTAs per SM stream pages
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = max(1, min(cache.pages_per_slot, -(-4 * n_sm // (s_slots * h))))
    part = torch.empty((s_slots, h, nsplit, d_v + 2), dtype=torch.float32, device=dev)
    out = torch.empty((s_slots, h * d_v), dtype=torch.float32, device=dev)
    err = build.launcher("paged_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        length.data_ptr(), None if bias is None else bias.data_ptr(), part.data_ptr(), out.data_ptr(),
        s_slots, h, d_qk, d_v, cache.page_size, cache.pages_per_slot, nsplit,
        build.current_stream(dev),
    )
    build.check(err, "paged_decode")
    build.count_launch("paged_decode")
    return out.reshape(s_slots, h, d_v)


def paged_decode_attention(qh: torch.Tensor, cache, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query attention over paged KV: ``qh`` (S, H, Dk) scaled and
    rotated, ``cache`` a float ``PagedKVCache`` (f32 on the card), ``mask``
    an optional (S, capacity) bool, True = masked, on top of the slot
    validity. Returns (S, H, Dv); the caller merges heads.

    Decode only: it has no gradient (nor has the JAX kernel a VJP), so an
    input that requires grad under grad mode raises rather than return an
    output cut off from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qh, cache.k, cache.v)):
        raise RuntimeError("paged_decode_attention has no gradient: call it under torch.no_grad() "
                           "or with inputs that do not require grad")
    if qh.is_cuda:
        return _paged_decode_cuda(qh, cache, mask)
    return paged_attention_reference(qh, cache, mask)
