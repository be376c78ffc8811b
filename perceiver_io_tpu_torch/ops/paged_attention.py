"""Paged decode attention (K3) and its plain PyTorch version.

Counterpart of ``perceiver_io_tpu/ops/paged_attention.py``. One query per
decode slot attends over that slot's pages of a :class:`PagedKVCache` pool:
token ``t`` of slot ``s`` lives at ``(page_table[s, t // page], t % page)``.
Slot validity (``j >= length[s]`` is masked) always applies; an optional
``(S, capacity)`` bool mask (True = masked) adds the caller's left pads and
expired window slots. (The JAX function's ``mask`` replaces the validity
mask instead; its callers always include validity in it, so the results
agree.)

The CUDA kernel (``csrc/paged_decode.cu``; f32 or bf16 q and pools of one
dtype, the output in it; head dims up to 512) walks the page tables of
all slots as one list, split into equal runs of pages over a fixed grid of
CTAs (:func:`paged_work_items` is that rule in plain Python), copies whole
pages into shared memory ahead of use, reads the mask as bytes, and merges
each slot's partials in a second launch;
:func:`paged_attention_reference` rebuilds the contiguous view with
``gather_view`` and runs dense attention. The two agree on every slot, a
slot whose every valid token is masked and a slot of length 0 included
(both then average the slot's whole capacity, as JAX does: there every
token scores the finite ``MASK_VALUE``).
Dispatch is by device, as in ``ops/flash_attention.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from perceiver_io_tpu_torch.ops import build
from perceiver_io_tpu_torch.ops.flash_attention import _DTYPE_CODES, MASK_VALUE


# K3's widest head (16 channels a lane of a warp), the heads-major K8's limit
PAGED_MAX_HEAD_DIM = 512


def paged_kernel_supported(cache, num_heads: int, d_qk: int, d_v: int) -> bool:
    """Whether the kernel serves this pool: f32 or bf16 pools (the engine's
    ``cache_dtype``) and head dims up to 512. int8 pools take the gather
    route, as JAX's gate keeps them off its kernel."""
    return (not cache.quantized and cache.k.dtype in _DTYPE_CODES and cache.v.dtype == cache.k.dtype
            and 1 <= d_qk <= PAGED_MAX_HEAD_DIM and 1 <= d_v <= PAGED_MAX_HEAD_DIM)


def reference_kernel_geometry(cache, num_heads: int, d_qk: int, d_v: int) -> bool:
    """Whether the JAX package's page-walk kernel serves this geometry: its
    gate takes any float pool with pages of at least 8 rows whose packed
    head widths (H * D) are multiples of 128 lanes, and no int8 pool. Where
    it does not, the JAX package gathers, and so may the port."""
    return (not cache.quantized and cache.page_size >= 8 and (num_heads * d_qk) % 128 == 0
            and (num_heads * d_v) % 128 == 0)


def paged_attention_reference(qh: torch.Tensor, cache, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: gather view + dense attention; softmax in f32, value
    product in the storage dtype. ``qh`` (S, H, Dk) -> (S, H, Dv). Float
    pools only (int8 pools never reach the kernel)."""
    if cache.quantized:
        raise TypeError("paged_decode_attention takes float pools; int8 pools take the gather route")
    k_slots, v_slots, _, _ = cache.gather_view()
    s_slots, cap = k_slots.shape[0], k_slots.shape[1]
    invalid = torch.arange(cap, device=cache.k.device)[None, :] >= cache.length[:, None]
    mask = invalid if mask is None else invalid | mask
    h, d_qk = qh.shape[1], qh.shape[2]
    d_v = cache.v.shape[2] // h
    k_h = k_slots.reshape(s_slots, cap, h, d_qk)
    v_h = v_slots.reshape(s_slots, cap, h, d_v)
    acc = torch.float64 if qh.dtype == torch.float64 else torch.float32  # f64 copies evaluate in f64
    scores = torch.einsum("bhc,bjhc->bhj", qh.to(acc), k_h.to(acc))
    scores = scores.masked_fill(mask[:, None, :], MASK_VALUE)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhj,bjhc->bhc", attn.to(v_h.dtype), v_h)


class WorkItem(NamedTuple):
    """One run of consecutive pages of one slot (and head group) that one CTA
    of K3's walk streams; its partial lands in scratch row ``index``."""

    cta: int
    group: int
    slot: int
    first_page: int
    pages: int
    index: int


def paged_work_items(lengths: Sequence[int], page: int, grid: int, capacity: Optional[int] = None,
                     groups: int = 1) -> List[WorkItem]:
    """K3's partition of the walk, in plain Python (the kernel computes the
    same on the device from the lengths). Slot ``s`` has ``ceil(len_s /
    page)`` pages (lengths clamped to ``[0, capacity]``); the pages of all
    slots, repeated once per head group, form one list of ``P_tot`` pages,
    and CTA ``b`` takes the ``chunk = ceil(P_tot / grid)`` pages from ``b *
    chunk``. Where that run crosses a slot boundary it is cut into items, so
    no item crosses a slot; there are at most ``grid + S * groups`` items
    and no CTA has more than ``chunk`` pages. Item (virtual slot ``v = g * S
    + s``, CTA ``b``) writes scratch row ``v + b``: rows are unique because
    a slot's items have consecutive CTAs and the next slot starts at the CTA
    where its predecessor ended, or later."""
    def clamped(x):
        x = max(int(x), 0)
        return x if capacity is None else min(x, int(capacity))

    n = [-(-clamped(x) // page) for x in lengths]
    p1 = sum(n)
    total = groups * p1
    if total == 0:
        return []
    chunk = -(-total // grid)
    items = []
    off = 0
    for g in range(groups):
        for s, n_s in enumerate(n):
            for b in range(off // chunk, (off + n_s - 1) // chunk + 1) if n_s else ():
                lo, hi = max(off, b * chunk), min(off + n_s, (b + 1) * chunk)
                items.append(WorkItem(b, g, s, lo - off, hi - lo, g * len(n) + s + b))
            off += n_s
    return items


class KernelPlan(NamedTuple):
    """K3's launch geometry from ``pio_paged_decode_plan``: the walk's grid
    of CTAs, head groups, heads a group, rows a shared-memory stage, stages,
    dynamic shared-memory bytes and consumer warps a CTA."""

    grid: int
    groups: int
    heads_per_group: int
    rows: int
    stages: int
    smem_bytes: int
    consumer_warps: int


@functools.lru_cache(maxsize=None)
def kernel_plan(device_index: int, slots: int, h: int, d_qk: int, d_v: int, page: int,
                dtype: torch.dtype = torch.float32) -> KernelPlan:
    """K3's plan for this geometry and dtype on the card, from the runtime
    (its SM count and shared memory)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        err = build.launcher("paged_decode_plan")(slots, h, d_qk, d_v, page, sms, _DTYPE_CODES[dtype], out)
    build.check(err, "paged_decode plan")
    return KernelPlan(*out)


def _paged_decode_cuda(qh, cache, mask):
    s_slots, h, d_qk = qh.shape
    d_v = cache.v.shape[2] // h
    dtype = qh.dtype
    if dtype not in _DTYPE_CODES or cache.k.dtype != dtype or cache.v.dtype != dtype:
        raise TypeError(f"paged_decode_attention takes f32 or bf16 q and pools of one dtype, got "
                        f"{qh.dtype}/{cache.k.dtype}/{cache.v.dtype}")
    if d_qk > PAGED_MAX_HEAD_DIM or d_v > PAGED_MAX_HEAD_DIM:
        raise ValueError(f"paged decode kernel takes head dims <= {PAGED_MAX_HEAD_DIM}, got ({d_qk}, {d_v})")
    dev = qh.device
    tensors = [cache.k, cache.v, cache.page_table, cache.length] + ([] if mask is None else [mask])
    if any(t.device != dev for t in tensors):
        raise ValueError("query, pools, page table, lengths and mask must lie on one CUDA device")
    if cache.k.shape[2] != h * d_qk:
        raise ValueError(f"query heads {h}x{d_qk} do not match the K pool width {cache.k.shape[2]}")
    for name in ("page_table", "length"):
        t = getattr(cache, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"the cache's {name} must be contiguous int32, got {t.dtype} "
                             f"(contiguous: {t.is_contiguous()})")
    if not (cache.k.is_contiguous() and cache.v.is_contiguous()):
        raise ValueError("paged decode kernel takes contiguous pools")
    mask_ptr, mask_stride = None, 0
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (s_slots, cache.capacity) or mask.stride(1) != 1:
            raise ValueError(f"mask must be a ({s_slots}, {cache.capacity}) bool tensor with unit column "
                             f"stride, got {mask.dtype} {tuple(mask.shape)} strides {mask.stride()}")
        mask_ptr, mask_stride = mask.data_ptr(), mask.stride(0)
    q = qh.reshape(s_slots, h * d_qk).contiguous()
    plan = kernel_plan(dev.index, s_slots, h, d_qk, d_v, cache.page_size, dtype)
    n_part = plan.grid + s_slots * plan.groups
    part = torch.empty((n_part * plan.heads_per_group * (d_v + 2),), dtype=torch.float32, device=dev)
    out = torch.empty((s_slots, h * d_v), dtype=dtype, device=dev)
    err = build.launcher("paged_decode")(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(), cache.page_table.data_ptr(), cache.length.data_ptr(),
        mask_ptr, mask_stride, part.data_ptr(), out.data_ptr(), s_slots, h, d_qk, d_v, cache.page_size,
        cache.pages_per_slot, plan.grid, plan.groups, plan.heads_per_group, plan.rows, plan.stages,
        plan.consumer_warps, _DTYPE_CODES[dtype], build.current_stream(dev),
    )
    build.check(err, "paged_decode")
    build.count_launch("paged_decode", dtype)
    return out.reshape(s_slots, h, d_v)


def paged_decode_attention(qh: torch.Tensor, cache, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query attention over paged KV: ``qh`` (S, H, Dk) scaled and
    rotated, ``cache`` a float ``PagedKVCache`` (on the card f32 or bf16 pools
    of ``qh``'s dtype, head dims up to 512), ``mask`` an optional (S,
    capacity) bool, True = masked, on top of the slot validity. Returns (S,
    H, Dv): on the card in ``qh``'s dtype, in the plain version in the
    pools' (which rounds the softmax weights to it before the value product,
    as the JAX package's plain version does); the caller merges heads.

    Decode only: it has no gradient (nor has the JAX kernel a VJP), so an
    input that requires grad under grad mode raises rather than return an
    output cut off from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qh, cache.k, cache.v)):
        raise RuntimeError("paged_decode_attention has no gradient: call it under torch.no_grad() "
                           "or with inputs that do not require grad")
    if qh.is_cuda:
        return _paged_decode_cuda(qh, cache, mask)
    return paged_attention_reference(qh, cache, mask)
