"""KV-cache disciplines: the contiguous :class:`KVCache` and the paged
:class:`PagedKVCache` (counterpart of ``perceiver_io_tpu/core/cache.py``).

Both store f32, bf16 or int8. int8 storage (``dtype=torch.int8`` at init)
keeps one bf16 scale a token in ``k_scale``/``v_scale`` planes shaped like the
slots (contiguous, (B, capacity)) or the pages (paged, (num_pages,
page_size)); :func:`quantize_kv` is the JAX package's, bit for bit, and every
write of rows writes their scales beside them.

Keys are stored ROTATED (rotate-at-write): a token's rotary rotation rides it
into the cache, so cached keys are never touched again.

The port updates the large buffers IN PLACE where the JAX package returns
updated copies: ``KVCache.append``, ``PagedKVCache.append`` and
:func:`commit_prefill` write into the existing ``k``/``v`` storage (an append
moves the new tokens' bytes, never the whole buffer). A contiguous cache's
``length`` has two forms: a Python int (the prompt pass's, known on the
host) and a 0-d int32 tensor on the cache's device (the decode step's, JAX's
traced int32 scalar, :meth:`KVCache.on_device`), which the decode step writes
back in place (``generation._decode_step_body``) so that a CUDA graph of the
step reads it where it lies. For the small per-slot tensors of the paged
cache (``page_table``, ``length``) there are two forms too. The serving
engine's state is fixed for its whole life, since its decode step is a CUDA
graph that reads fixed addresses: :func:`commit_prefill_` and
:func:`release_slot_` write the table row and the length in place, and the
engine's decode step writes the advanced lengths back into the tensors it read
(``generation._decode_step_body``). The functional forms,
``PagedKVCache.append``, :func:`commit_prefill` and :func:`release_slot`,
return a cache with new ``page_table``/``length`` tensors and leave the old
ones as they were (its pools are shared, so the old object's pages must not
be read again).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from perceiver_io_tpu_torch.device import DeviceLike, resolve_device

# bf16(1.0079), the factor of JAX's nudge, exactly: a Python float multiplies
# a bf16 tensor in f32, where the product of two bf16 values is exact, and the
# result rounds once to bf16, as JAX's bf16 product does
_NUDGE = 1.0078125


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (..., N, C) -> int8 values and a (..., N)
    bf16 scale with ``x ~= q * scale`` (JAX's ``quantize_kv``, bit for bit).
    The scale is rounded to bf16 first and the values rounded against it as
    stored; where the stored scale times 127 falls short of the token's
    absmax it is nudged up by ``bf16(1.0079)`` so that ``|q| <= 127`` holds.
    Rounding is half to even, then the values are clipped to ±127."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8).to(torch.bfloat16)
    scale = torch.where(scale.float() * 127.0 < amax, scale * _NUDGE, scale)
    q = torch.round(x32 / scale.float()[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _stored(x: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == buf.dtype else x.to(buf.dtype)


@dataclass
class KVCache:
    """Fixed-capacity contiguous cache: ``k``/``v`` (B, capacity, C) with
    valid data in slots ``[0, length)``. ``length`` is a Python int, or a 0-d
    int32 tensor on the cache's device (see the module docstring). An int8
    cache keeps each token's bf16 scales in ``k_scale``/``v_scale`` (B,
    capacity); a float cache has None there."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def with_length(self, length) -> "KVCache":
        """The same buffers (scale planes included) at another length."""
        return KVCache(self.k, self.v, length, self.k_scale, self.v_scale)

    def map_slots(self, fn, length=None) -> "KVCache":
        """A cache of ``fn`` applied to every per-slot buffer (k, v and the
        scale planes where present; JAX's ``map_slots``), so a reorder, roll
        or tile of the slots can never drop the scales."""
        return KVCache(fn(self.k), fn(self.v), self.length if length is None else length,
                       None if self.k_scale is None else fn(self.k_scale),
                       None if self.v_scale is None else fn(self.v_scale))

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """k, v and, in an int8 cache, the two scale planes."""
        return (self.k, self.v) if self.k_scale is None else (self.k, self.v, self.k_scale, self.v_scale)

    def on_device(self) -> "KVCache":
        """The same buffers with ``length`` as a 0-d int32 tensor on their
        device (a new tensor: the cache's own form is left as it is)."""
        return self.with_length(torch.tensor(self.length, dtype=torch.int32, device=self.k.device))

    def append(self, k: torch.Tensor, v: torch.Tensor) -> "KVCache":
        """Write ``k``/``v`` (B, N, C), keys already rotated, at ``length``
        (in place); returns the advanced cache. A host length is checked
        against the capacity; a device length is not read (as in JAX's jit,
        the caller sizes the cache: ``generation`` gives it
        ``max_new_tokens`` of slack). An int8 cache stores the rows quantized
        and their scales beside them (rotate, then quantize: the scale is the
        stored rotated key's)."""
        n = k.shape[1]
        if self.quantized:
            (k_q, k_sc), (v_q, v_sc) = quantize_kv(k), quantize_kv(v)
            values = (k_q, v_q, k_sc, v_sc)
        else:
            values = (_stored(k, self.k), _stored(v, self.v))
        if torch.is_tensor(self.length):
            idx = self.length + torch.arange(n, device=self.k.device)
            for buf, x in zip(self.buffers(), values):
                buf.index_copy_(1, idx, x)
            return self.with_length(self.length + n)
        start = self.length
        if start + n > self.capacity:
            raise ValueError(f"KV cache overflow: {start} + {n} tokens > capacity {self.capacity}")
        for buf, x in zip(self.buffers(), values):
            buf[:, start:start + n] = x
        return self.with_length(start + n)


def _scale_planes(shape, dtype, device):
    """Two bf16 scale planes for an int8 cache (tensors of their own: both
    are written in place), or (None, None) for a float one."""
    if dtype != torch.int8:
        if not torch.empty((), dtype=dtype).is_floating_point():
            raise ValueError(f"a KV cache stores f32, bf16 or int8, got {dtype}")
        return None, None
    return tuple(torch.zeros(shape, dtype=torch.bfloat16, device=device) for _ in range(2))


def init_kv_cache(batch_size: int, capacity: int, num_qk_channels: int, num_v_channels: int,
                  dtype=torch.float32, device: DeviceLike = "cuda") -> KVCache:
    """Empty contiguous cache (length 0) on ``device`` (CUDA by default;
    without a card that raises, pass ``device="cpu"``). ``dtype=torch.int8``
    selects quantized storage with its scale planes."""
    device = resolve_device(device)
    k_scale, v_scale = _scale_planes((batch_size, capacity), dtype, device)
    return KVCache(
        k=torch.zeros((batch_size, capacity, num_qk_channels), dtype=dtype, device=device),
        v=torch.zeros((batch_size, capacity, num_v_channels), dtype=dtype, device=device),
        length=0, k_scale=k_scale, v_scale=v_scale,
    )


@dataclass
class PagedKVCache:
    """Paged cache: ``k``/``v`` (num_pages, page_size, C) pools shared by the
    decode slots; slot ``s`` owns the pages ``page_table[s]`` names and holds
    ``length[s]`` tokens — token ``t`` lives at
    ``(page_table[s, t // page_size], t % page_size)``.

    Page 0 is the SCRATCH page (``serving.pages.PageAllocator`` never hands
    it out): unowned table entries point at it, so an inactive slot's appends
    land there harmlessly and the batched step needs no per-slot branches.

    int8 pools keep each row's bf16 scales in ``k_scale``/``v_scale``
    (num_pages, page_size), as :class:`KVCache` does."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor  # (S, pages_per_slot) int32
    length: torch.Tensor  # (S,) int32
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def capacity(self) -> int:
        """Per-slot token capacity (the contiguous view's slot axis)."""
        return self.pages_per_slot * self.page_size

    @property
    def slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """The pools: k, v and, in an int8 cache, the two scale planes."""
        return (self.k, self.v) if self.k_scale is None else (self.k, self.v, self.k_scale, self.v_scale)

    def with_slot_tensors(self, page_table: torch.Tensor, length: torch.Tensor) -> "PagedKVCache":
        """The same pools (scale planes included) with other table and
        length tensors."""
        return PagedKVCache(self.k, self.v, page_table, length, self.k_scale, self.v_scale)

    def _write(self, index, k: torch.Tensor, v: torch.Tensor) -> None:
        """Store rows at pool positions ``index`` (page ids, offsets), with
        their scales in an int8 pool, one ``index_put_`` a buffer."""
        if self.quantized:
            (k_q, k_sc), (v_q, v_sc) = quantize_kv(k), quantize_kv(v)
            values = (k_q, v_q, k_sc, v_sc)
        else:
            values = (_stored(k, self.k), _stored(v, self.v))
        for buf, x in zip(self.buffers(), values):
            buf.index_put_(index, x)

    def append(self, k: torch.Tensor, v: torch.Tensor) -> "PagedKVCache":
        """Append ONE token per slot (``k``/``v`` (S, 1, C), keys rotated)
        into the pool, in place. Overflowing slots clamp to their last page
        (inactive slots point at scratch and never overflow live data)."""
        if k.shape[1] != 1:
            raise ValueError(f"paged append is one token per slot, got {k.shape[1]}")
        pos = self.length.long()
        page_idx = torch.clamp(pos // self.page_size, max=self.pages_per_slot - 1)
        page_id = torch.gather(self.page_table.long(), 1, page_idx[:, None])[:, 0]
        offset = pos % self.page_size
        self._write((page_id, offset), k[:, 0], v[:, 0])
        return self.with_slot_tensors(self.page_table, self.length + 1)

    def append_span(self, k: torch.Tensor, v: torch.Tensor) -> "PagedKVCache":
        """Append ``n`` tokens per slot (``k``/``v`` (S, n, C), keys rotated)
        into the pool, in place: token ``i`` of slot ``s`` lands at position
        ``length[s] + i``, its page id read through the table and clamped
        into the slot's last page (callers give every slot's page span the
        span's slack), one ``index_put_`` a pool. Returns the cache with
        ``length + n``; rolling a rejected suffix back is the caller's move
        of ``length`` (the slots past it are dead until the next span
        overwrites them)."""
        n = k.shape[1]
        pos = self.length.long()[:, None] + torch.arange(n, device=self.length.device)[None, :]  # (S, n)
        page_idx = torch.clamp(pos // self.page_size, max=self.pages_per_slot - 1)
        page_id = torch.gather(self.page_table.long(), 1, page_idx)
        offset = pos % self.page_size
        self._write((page_id, offset), k, v)
        return self.with_slot_tensors(self.page_table, self.length + n)

    def gather_view(self) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The contiguous view of every slot's pages (copies), as JAX's
        4-tuple: k and v (S, capacity, C) and, in an int8 cache, the scales
        (S, capacity) (else None, None) — what the gather route reads."""
        idx = self.page_table.reshape(-1).long()
        s, cap = self.slots, self.capacity
        views = [buf[idx].reshape((s, cap) + tuple(buf.shape[2:])) for buf in self.buffers()]
        return tuple(views) if self.quantized else (views[0], views[1], None, None)


def init_paged_kv_cache(slots: int, num_pages: int, page_size: int, pages_per_slot: int,
                        num_qk_channels: int, num_v_channels: int, dtype=torch.float32,
                        device: DeviceLike = "cuda") -> PagedKVCache:
    """Empty paged cache on ``device`` (CUDA by default, as
    :func:`init_kv_cache`): every table entry points at scratch page 0, every
    length is 0."""
    if num_pages < 2:
        raise ValueError("need at least 2 pages (page 0 is reserved scratch)")
    device = resolve_device(device)
    k_scale, v_scale = _scale_planes((num_pages, page_size), dtype, device)
    return PagedKVCache(
        k=torch.zeros((num_pages, page_size, num_qk_channels), dtype=dtype, device=device),
        v=torch.zeros((num_pages, page_size, num_v_channels), dtype=dtype, device=device),
        page_table=torch.zeros((slots, pages_per_slot), dtype=torch.int32, device=device),
        length=torch.zeros((slots,), dtype=torch.int32, device=device),
        k_scale=k_scale, v_scale=v_scale,
    )


def commit_prefill_(paged: PagedKVCache, slot: int, page_ids: torch.Tensor,
                    prefill_cache: KVCache, n_tokens: int) -> None:
    """Move one request's prompt KV from a contiguous prefill cache (batch 1)
    into its freshly granted pages ``page_ids`` (n,), and point slot
    ``slot``'s table row at them, in place (table row and length included).
    Rows past ``n_tokens`` in the last page carry the prefill buffer's slack
    (or zeros); reads mask them. An int8 pool takes the rows' scales too; a
    quantized cache into an unquantized one (or the reverse) raises, as in
    JAX."""
    if paged.quantized != prefill_cache.quantized:
        raise ValueError("paged cache is int8 but the prefill cache is not" if paged.quantized
                         else "prefill cache is int8 but the paged cache is not")
    page_ids = page_ids.to(device=paged.k.device, dtype=torch.long)
    n = page_ids.shape[0]
    page_size = paged.page_size

    def rows_of(buf):
        want = n * page_size
        rows = buf[0]
        if rows.shape[0] < want:
            rows = torch.cat([rows, rows.new_zeros((want - rows.shape[0],) + tuple(rows.shape[1:]))])
        return rows[:want].reshape((n, page_size) + tuple(buf.shape[2:]))

    for buf, rows in zip(paged.buffers(), prefill_cache.buffers()):
        buf[page_ids] = rows_of(rows).to(buf.dtype)
    paged.page_table[slot] = 0
    paged.page_table[slot, :n] = page_ids.to(torch.int32)
    paged.length[slot] = int(n_tokens)


def release_slot_(paged: PagedKVCache, slot: int) -> None:
    """Point a retired slot's table row back at scratch and zero its length,
    in place; no pool bytes move (the host half returns the pages to the
    allocator)."""
    paged.page_table[slot] = 0
    paged.length[slot] = 0


def _with_own_slot_tensors(paged: PagedKVCache) -> PagedKVCache:
    return paged.with_slot_tensors(paged.page_table.clone(), paged.length.clone())


def commit_prefill(paged: PagedKVCache, slot: int, page_ids: torch.Tensor,
                   prefill_cache: KVCache, n_tokens: int) -> PagedKVCache:
    """:func:`commit_prefill_` into a cache with new table and length
    tensors (the functional form); returns it."""
    out = _with_own_slot_tensors(paged)
    commit_prefill_(out, slot, page_ids, prefill_cache, n_tokens)
    return out


def release_slot(paged: PagedKVCache, slot: int) -> PagedKVCache:
    """:func:`release_slot_` into a cache with new table and length tensors
    (the functional form); returns it."""
    out = _with_own_slot_tensors(paged)
    release_slot_(out, slot)
    return out
