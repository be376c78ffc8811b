"""Multi-head attention with contiguous and paged KV caches (counterpart of
``perceiver_io_tpu/core/attention.py::MultiHeadAttention``).

Routes, each numerically the JAX package's:

- no cache, with an active dropout on the attention probabilities: the
  dense path below, the probabilities dropped in f32 before the ``P V``
  product (the JAX package's gate refuses its kernels under dropout and
  computes this route with einsums);
- no cache otherwise: by head dims, never by device or length. Dims the packed
  layout takes (multiples of 8 up to 128) go to the packed flash kernel K2
  (``ops.flash_attention``) over the projection layout; other dims up to
  512 (odd widths, wide heads) to the heads-major kernel K8, on heads split
  to (B, H, N, D) with scaled, rotated queries; wider heads to the dense
  path, as the JAX package's ``flash_supported`` sends them. The Perceiver
  AR cross-attention may instead take :meth:`MultiHeadAttention.two_segment`
  (K6 and its backward K7a/K7b), which projects the prefix and the latents
  separately and never joins them;
- contiguous cache that entered EMPTY with more than one query (the prompt
  pass): keys rotate and land in the cache, and the same dispatch computes
  the attention over the fresh keys/values — the prompt pass's cache length
  is a host int, so no context flag is needed to tell a prefill from a
  decode;
- contiguous cache that entered FILLED (a host length > 0) with more than
  one query (the shared-prefix prefill's cross-attention: the resident
  prefix rows were gathered into the cache, the suffix's rows are
  appended): K2 over the filled slots ``[0, length)``, keys as the cache
  holds them (rotated at write), the causal mask right-aligned, where the
  packed kernels take the head dims. The JAX package runs its einsum over
  the slots here; K2 computes the same function, and the unshared prefill's
  arithmetic;
- any other contiguous cache call (the sequential decode step, whose cache
  length is a device tensor that no route reads back), and the
  routes above for head dims their kernels cannot take: the dense path over
  the slots, scores in f32, masked by the slot validity, the pad mask and
  the right-aligned causal mask;
- paged cache (the engine's batched one-token step): page-indexed append,
  then, by the pools' geometry, the paged decode kernel K3
  (``ops.paged_attention``: f32 or bf16 pools, head dims up to 512) or,
  where the JAX package gathers too (int8 pools, or on the CPU), the gather
  route (the contiguous view of every slot's pages, then the dense path);
- paged cache with more than one query (the speculative verify span of
  ``generation.make_speculative_paged_step_fn``): ``append_span``, then the
  gather route with a right-aligned causal mask per slot, for every
  geometry, as in the JAX package (its page-walk kernel is single-query).

Keys are rotated once at write (rotate-at-write); ``rope_k`` covers only the
tokens being appended. Queries are scaled by ``Dqk**-0.5`` before rotation.

int8 caches (``core.cache``: int8 rows, one bf16 scale a token) are read in
JAX's order on each route: the one-query decode routes (the contiguous one
under JAX's block-diagonal gate, and the paged gather route) fold the scales
outside the two products; the span, the generic cached path and a prefill
whose kernels refuse the head dims dequantize in full first. A prefill runs
its kernel over the fresh, unquantized keys, and the cache stores them
quantized, where JAX's prefill takes its kernel (128 or more tokens, head dims
its packed kernel takes); shorter prompts read the cache they just wrote,
dequantized, as JAX's einsum does there.

``dtype`` is the compute dtype, Flax's ``nn.Dense(dtype=...)``: the
parameters stay f32 and each projection casts its input and weights to
``dtype`` (:func:`dense`), so in bf16 the projections, the attention
operands and the output are bf16, the scores and softmax f32.

The numerics probe ``attention.out`` (``obs.probes.probe``, a no-op unless a
collector is open) taps the output of every cache-free route and of the
generic cached path. The JAX package taps its einsum route's output, which at
the CPU's shapes (fewer than 128 queries or keys, or flash off) is every
cache-free call: the port's snapshot keys are that route-independent set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from perceiver_io_tpu_torch.core.cache import KVCache, PagedKVCache
from perceiver_io_tpu_torch.core.dropout import dropout as apply_dropout
from perceiver_io_tpu_torch.core.position import apply_rotary_pos_emb
from perceiver_io_tpu_torch.core.remat import offloaded_linear
from perceiver_io_tpu_torch.obs.probes import probe
from perceiver_io_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_2seg,
    flash_supported,
    packed_supported,
)
from perceiver_io_tpu_torch.ops.paged_attention import (
    PAGED_MAX_HEAD_DIM,
    paged_decode_attention,
    paged_kernel_supported,
    reference_kernel_geometry,
)

_NEG_MAX = -torch.finfo(torch.float32).max


def dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``linear`` applied in the compute dtype, as Flax's ``nn.Dense(dtype=
    dtype)`` applies its f32 parameters: input, weight and bias cast to
    ``dtype``, the product (f32 sums on the tensor cores) in ``dtype``. Where
    all three are ``dtype`` already (the f32 default), ``linear(x)`` as it
    is (a decode step on int8 weights puts weights of the compute dtype in
    place of the f32 ones, its biases stay f32). Inside an offloaded layer
    body (``core.remat``) the product goes through the offload, which keeps
    its output on the host for the recompute."""
    if x.dtype == dtype and linear.weight.dtype == dtype and (linear.bias is None or linear.bias.dtype == dtype):
        x_dt, w_dt, bias = x, linear.weight, linear.bias
    else:
        x_dt, w_dt = x.to(dtype), linear.weight.to(dtype)
        bias = None if linear.bias is None else linear.bias.to(dtype)
    if isinstance(w_dt, DTensor):
        return _tensor_parallel_linear(x_dt, w_dt, bias)
    y = offloaded_linear(x_dt, w_dt, bias)
    return nn.functional.linear(x_dt, w_dt, bias) if y is None else y


def _tensor_parallel_linear(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """A Linear sharded over the mesh's ``tensor`` axis
    (``training.loop.shard_train_state``'s ``parallelize_module``): what
    ``ColwiseParallel`` and ``RowwiseParallel`` do around a module call,
    which :func:`dense`'s cast to the compute dtype bypasses. Column-parallel
    (the weight's ``Shard(0)``): the replicated input in, this rank's block
    of the output channels out. Row-parallel (``Shard(1)``): this rank's
    block of the input channels in, the whole output, summed over the axis,
    out. In the backward the replicated input's gradient is summed over the
    axis (``DTensor.from_local``'s)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = weight.device_mesh
    col = weight.placements[0] == Shard(0)
    xd = DTensor.from_local(x, mesh, [Replicate()] if col else [Shard(x.dim() - 1)], run_check=False)
    y = nn.functional.linear(xd, weight, bias)
    return y.to_local() if col else y.redistribute(mesh, [Replicate()]).to_local()


class AttentionOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    kv_cache: Optional[Union[KVCache, PagedKVCache]] = None


class MultiHeadAttention(nn.Module):
    """Multi-head attention (Perceiver IO Appendix E) with q/k/v/o
    projections named as in the reference implementation."""

    def __init__(
        self,
        num_heads: int,
        num_q_input_channels: int,
        num_kv_input_channels: int,
        num_qk_channels: Optional[int] = None,
        num_v_channels: Optional[int] = None,
        num_output_channels: Optional[int] = None,
        causal_attention: bool = False,
        qkv_bias: bool = True,
        out_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.num_heads = num_heads
        self.qk_channels = num_qk_channels if num_qk_channels is not None else num_q_input_channels
        self.v_channels = num_v_channels if num_v_channels is not None else self.qk_channels
        out_channels = num_output_channels if num_output_channels is not None else num_q_input_channels
        if self.qk_channels % num_heads != 0:
            raise ValueError("num_qk_channels must be divisible by num_heads")
        if self.v_channels % num_heads != 0:
            raise ValueError("num_v_channels must be divisible by num_heads")
        self.causal_attention = causal_attention
        self.q_proj = nn.Linear(num_q_input_channels, self.qk_channels, bias=qkv_bias)
        self.k_proj = nn.Linear(num_kv_input_channels, self.qk_channels, bias=qkv_bias)
        self.v_proj = nn.Linear(num_kv_input_channels, self.v_channels, bias=qkv_bias)
        self.o_proj = nn.Linear(self.v_channels, out_channels, bias=out_bias)

    def _proj(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(linear, x, self.dtype)

    # the size of the tensor axis this layer's heads are split over
    # (``shard_heads``); 1 where it holds every head
    tensor_size = 1

    def shard_heads(self, tensor_size: int) -> None:
        """Hold ``num_heads / tensor_size`` heads, the local ones of a
        tensor-parallel rank (``training.loop.shard_train_state``): the
        projections' sharded channels are whole heads, so every route and
        kernel runs on the local heads as on a narrower layer."""
        if self.num_heads % tensor_size:
            raise ValueError(f"{self.num_heads} heads do not split over a tensor axis of {tensor_size}")
        self.tensor_size = tensor_size
        self.num_heads //= tensor_size
        self.qk_channels //= tensor_size
        self.v_channels //= tensor_size

    @property
    def d_qk(self) -> int:
        return self.qk_channels // self.num_heads

    @property
    def d_v(self) -> int:
        return self.v_channels // self.num_heads

    def packed_route_ok(self) -> bool:
        """The gate shared by every packed-flash route (the cache-free and
        prefill routes below, and ``CrossAttention``'s two-segment dispatch):
        whether the packed kernels take this layer's head dims."""
        return packed_supported(self.num_heads, self.d_qk, self.d_v)

    def _rotate_keys(self, k: torch.Tensor, rope_k: Optional[torch.Tensor]) -> torch.Tensor:
        """Rotate packed keys (B, M, H*D) in place of layout: (B, M, H, D) is
        a view, so no head transpose is made."""
        if rope_k is None:
            return k
        b, m = k.shape[0], k.shape[1]
        k4 = apply_rotary_pos_emb(k.reshape(b, m, self.num_heads, self.d_qk), rope_k[:, :, None, :])
        return k4.reshape(k.shape)

    def _scaled_rotated_queries(self, q, rope_q):
        """Scale and rotate q in the packed layout (B, N, H*Dqk)."""
        b, n = q.shape[0], q.shape[1]
        q4 = q.reshape(b, n, self.num_heads, self.d_qk) * self.d_qk**-0.5
        if rope_q is not None:
            q4 = apply_rotary_pos_emb(q4, rope_q[:, :, None, :])
        return q4.reshape(q.shape)

    def _packed_flash(self, q, k, v, rope_q, pad_mask):
        """Run K2 on scaled, rotated queries (keys arrive rotated)."""
        return flash_attention_packed(
            self._scaled_rotated_queries(q, rope_q), k, v, num_heads=self.num_heads, pad_mask=pad_mask,
            causal=self.causal_attention, sm_scale=1.0,
        )

    def two_segment(self, x_q, x_kv_prefix, pad_mask_prefix=None, pad_mask_latent=None, rope_q=None,
                    rope_k_prefix=None, rope_k_latent=None) -> AttentionOutput:
        """Causal prefix cross-attention of ``x_q`` (B, Nq, Dq) over the
        logical kv sequence ``[x_kv_prefix; x_q]`` without joining it (the
        ``fast_kernels`` "twoseg" route, K6/K7a/K7b): both inputs arrive
        layer-normed, the latents and the prefix are projected separately
        (projections are row-wise), each key segment rotates with its own
        encodings, and ``flash_attention_packed_2seg`` reads the two K/V
        pairs where they lie. No KV cache on this route."""
        q = self._proj(self.q_proj, x_q)
        k_l = self._rotate_keys(self._proj(self.k_proj, x_q), rope_k_latent)
        v_l = self._proj(self.v_proj, x_q)
        k_p = self._rotate_keys(self._proj(self.k_proj, x_kv_prefix), rope_k_prefix)
        v_p = self._proj(self.v_proj, x_kv_prefix)
        o = flash_attention_packed_2seg(
            self._scaled_rotated_queries(q, rope_q), k_p, v_p, k_l, v_l, num_heads=self.num_heads,
            pad_mask_prefix=pad_mask_prefix, pad_mask_latent=pad_mask_latent, sm_scale=1.0,
        )
        return AttentionOutput(probe("attention.out", self._proj(self.o_proj, o)), None)

    def _split_heads(self, x: torch.Tensor, d: int) -> torch.Tensor:
        b, n = x.shape[0], x.shape[1]
        return x.reshape(b, n, self.num_heads, d).transpose(1, 2)

    def _scaled_query_heads(self, q, rope_q):
        qh = self._split_heads(q, self.d_qk) * self.d_qk**-0.5
        if rope_q is not None:
            qh = apply_rotary_pos_emb(qh, rope_q[:, None, :, :])
        return qh  # (B, H, N, Dk)

    def project_q(self, x_q: torch.Tensor, rope_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queries as scaled (and rotated) heads (B, H, N, Dk): the query
        pipeline of ``forward``, for callers that attend themselves."""
        return self._scaled_query_heads(self._proj(self.q_proj, x_q), rope_q)

    def project_kv(self, x_kv: torch.Tensor, rope_k: Optional[torch.Tensor] = None):
        """Keys (rotated) and values as heads, ((B, H, M, Dk), (B, H, M, Dv)):
        the cache-free key/value pipeline of ``forward``."""
        k = self._split_heads(self._proj(self.k_proj, x_kv), self.d_qk)
        if rope_k is not None:
            k = apply_rotary_pos_emb(k, rope_k[:, None, :, :])
        return k, self._split_heads(self._proj(self.v_proj, x_kv), self.d_v)

    def merge_output(self, o: torch.Tensor) -> torch.Tensor:
        """Head merge + output projection: (B, H, N, Dv) -> (B, N, out)."""
        b, _, n, _ = o.shape
        return self._proj(self.o_proj, o.transpose(1, 2).reshape(b, n, self.v_channels))

    def _fresh_flash(self, q, k, v, rope_q, pad_mask) -> Optional[torch.Tensor]:
        """Attention over fresh packed keys/values (B, M, H*D), keys rotated,
        by head dims: K2 where the packed kernels take them, else the
        heads-major K8 up to 512; None for wider heads (the dense path)."""
        if self.packed_route_ok():
            return self._packed_flash(q, k, v, rope_q, pad_mask)
        if not flash_supported(self.d_qk, self.d_v):
            return None
        o = flash_attention(self._scaled_query_heads(q, rope_q), self._split_heads(k, self.d_qk),
                            self._split_heads(v, self.d_v), pad_mask=pad_mask, causal=self.causal_attention,
                            sm_scale=1.0)
        return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], self.v_channels)

    def _dense(self, q, k, v, rope_q, masked, attn_keep=None, scales=None, fold=False):
        """Plain attention over packed k/v (B, M, H*D); ``masked`` (B|1, N|1,
        M) bool, True = masked. Scores and softmax in f32; ``attn_keep`` (B,
        H, N, M), where given, is the dropout of the f32 probabilities.

        ``scales`` (k_scale, v_scale), each (B, M), mark int8 k/v and are
        applied in one of JAX's two orders. ``fold`` (its single-query decode
        routes): the int8 values enter both products as they are, the scores
        are ``(q . k) * k_scale`` in f32, and the probabilities times
        ``v_scale`` are rounded to the compute dtype before the value
        product. Otherwise (its generic and span routes) k and v are
        dequantized in full first, ``k.to(dt) * k_scale.to(dt)`` in the
        compute dtype ``dt``."""
        b, n, m = q.shape[0], q.shape[1], k.shape[1]
        h = self.num_heads
        qh = self._scaled_query_heads(q, rope_q)
        fold = fold and scales is not None
        if scales is not None and not fold:
            k = k.to(q.dtype) * scales[0][..., None].to(q.dtype)
            v = v.to(q.dtype) * scales[1][..., None].to(q.dtype)
        kh = k.reshape(b, m, h, self.d_qk)
        vh = v.reshape(b, m, h, self.d_v)
        scores = torch.einsum("bhic,bjhc->bhij", qh.float(), kh.float())
        if fold:
            scores = scores * scales[0][:, None, None, :].float()
        scores = scores.masked_fill(masked[:, None, :, :], _NEG_MAX)
        attn = apply_dropout(torch.softmax(scores, dim=-1), attn_keep, self.dropout)
        if fold:
            aw, vh = (attn * scales[1][:, None, None, :].float()).to(q.dtype), vh.to(q.dtype)
        else:
            aw = attn.to(vh.dtype)
        o = torch.einsum("bhij,bjhc->bihc", aw, vh)
        return o.reshape(b, n, self.v_channels)

    def _prefill_reads_fresh_keys(self, n_q: int, n_kv: int) -> bool:
        """Whether an int8 cache's prefill attends over the fresh keys: where
        JAX's prefill takes its kernel on its chip (``packed_route_ok``:
        head dims multiples of 8 up to 512, ``H * D`` up to 1024, 128 or more
        queries and keys). Elsewhere JAX's einsum reads the cache it just
        wrote, dequantized, and so does the port: over int8 rows the two
        are different functions, where over float rows they are one."""
        h, d_qk, d_v = self.num_heads, self.d_qk, self.d_v
        return (all(d % 8 == 0 and d <= 512 and h * d <= 1024 for d in (d_qk, d_v))
                and n_q >= 128 and n_kv >= 128)

    def _folds_decode_scales(self, n_q: int) -> bool:
        """JAX's gate of its block-diagonal contiguous decode, the route that
        folds an int8 cache's scales outside the products: one query, more
        than one head, and ``H * C`` within 8192 for both widths."""
        h = self.num_heads
        return n_q == 1 and h > 1 and h * self.qk_channels <= 8192 and h * self.v_channels <= 8192

    def _paged_decode_attend(self, q, cache: PagedKVCache, pad_mask, rope_q) -> AttentionOutput:
        """One query per slot over the paged pools. The route is chosen by
        the pools' geometry before anything launches: K3 where
        ``paged_kernel_supported`` holds (f32 or bf16 pools, head dims up
        to 512), else the gather route (one gather per pool rebuilds the
        contiguous view, then the dense decode attention of the contiguous
        cache) where the JAX package's own kernel refuses the geometry and it
        gathers too (int8 pools among them), or where the pools lie on the
        CPU. A float pool on the card that the JAX package's kernel serves and
        K3 does not (heads wider than 512) raises. An int8 pool's scales fold
        outside the products, as in JAX's gather route. bf16 queries over f32
        pools go to K3 as f32, which they are exactly (JAX's product promotes
        them the same way)."""
        b, h = q.shape[0], self.num_heads
        if not paged_kernel_supported(cache, h, self.d_qk, self.d_v):
            if cache.k.device.type != "cpu" and reference_kernel_geometry(cache, h, self.d_qk, self.d_v):
                raise ValueError(f"paged pool of dtype {cache.k.dtype}, head dims {self.d_qk}/{self.d_v}: "
                                 f"the reference's paged kernel serves it, K3 does not (head dims up to "
                                 f"{PAGED_MAX_HEAD_DIM})")
            k_slots, v_slots, k_scale, v_scale = cache.gather_view()
            masked = torch.arange(cache.capacity, device=q.device)[None, :] >= cache.length[:, None]
            if pad_mask is not None:
                masked = masked | pad_mask[:, : cache.capacity]
            o = self._dense(q, k_slots, v_slots, rope_q, masked[:, None, :],
                            scales=None if k_scale is None else (k_scale, v_scale), fold=True)
            return AttentionOutput(self._proj(self.o_proj, o), cache)
        qh = self._scaled_query_heads(q, rope_q)[:, :, 0, :]  # (B, H, Dk)
        if qh.dtype == torch.bfloat16 and cache.k.dtype == torch.float32:
            qh = qh.float()
        # slot validity (j >= length) is applied by the paged attention itself
        mask = None if pad_mask is None else pad_mask[:, : cache.capacity]
        o = paged_decode_attention(qh, cache, mask)  # (B, H, Dv)
        return AttentionOutput(self._proj(self.o_proj, o.reshape(b, 1, self.v_channels).to(q.dtype)), cache)

    def _paged_span_attend(self, q, cache: PagedKVCache, pad_mask, rope_q) -> AttentionOutput:
        """``n_q`` queries per slot over the paged pools, the span just
        appended (the speculative verify): the contiguous view of every
        slot's pages, then the dense path with per-slot validity and a
        right-aligned causal mask (query ``i`` of slot ``s`` sits at
        ``length[s] - n_q + i``), the caller's pad mask, f32 scores; an int8
        pool dequantized in full first. This is the route for every geometry,
        as in the JAX package."""
        n_q = q.shape[1]
        k_slots, v_slots, k_scale, v_scale = cache.gather_view()
        kv_idx = torch.arange(cache.capacity, device=q.device)
        q_abs = cache.length.long()[:, None] - n_q + torch.arange(n_q, device=q.device)[None, :]
        masked = kv_idx[None, None, :] > q_abs[:, :, None]  # (S, n_q, capacity)
        if pad_mask is not None:
            masked = masked | pad_mask[:, None, : cache.capacity]
        o = self._dense(q, k_slots, v_slots, rope_q, masked, scales=None if k_scale is None else (k_scale, v_scale))
        return AttentionOutput(self._proj(self.o_proj, o), cache)

    def forward(
        self,
        x_q: torch.Tensor,
        x_kv: torch.Tensor,
        pad_mask: Optional[torch.Tensor] = None,
        rope_q: Optional[torch.Tensor] = None,
        rope_k: Optional[torch.Tensor] = None,
        kv_cache: Optional[Union[KVCache, PagedKVCache]] = None,
        attn_keep: Optional[torch.Tensor] = None,
    ) -> AttentionOutput:
        """Attend ``x_q`` (B, N, Dq) to ``x_kv`` (B, M, Dkv).

        :param pad_mask: bool, True = padding: (B, M) without a cache,
            slot-aligned (B, capacity) with one.
        :param rope_q: rotary encodings of the queries (B, N, R), or None.
        :param rope_k: rotary encodings of ``x_kv``'s tokens (B, M, R), or None.
        :param kv_cache: the cache the new keys/values are appended to.
        :param attn_keep: the keep mask (B, H, N, M) of an active dropout on
            the attention probabilities (``core.dropout``): the call takes
            the dense route, as the JAX package's gate refuses its kernels
            under dropout. Cache-free calls only.
        """
        n_q, n_kv = x_q.shape[1], x_kv.shape[1]
        if attn_keep is not None and kv_cache is not None:
            raise ValueError("attention dropout applies to cache-free forwards, not to calls with a KV cache")
        q = self._proj(self.q_proj, x_q)
        k = self._rotate_keys(self._proj(self.k_proj, x_kv), rope_k)
        v = self._proj(self.v_proj, x_kv)

        if kv_cache is None:
            o = None if attn_keep is not None else self._fresh_flash(q, k, v, rope_q, pad_mask)
            if o is None:
                masked = torch.zeros((1, 1, n_kv), dtype=torch.bool, device=q.device)
                if pad_mask is not None:
                    masked = masked | pad_mask[:, None, :]
                if self.causal_attention:
                    masked = masked | self._causal(n_q, n_kv, n_kv, q.device)
                o = self._dense(q, k, v, rope_q, masked, attn_keep)
            return AttentionOutput(probe("attention.out", self._proj(self.o_proj, o)), None)

        if isinstance(kv_cache, PagedKVCache):
            if n_q != 1:
                return self._paged_span_attend(q, kv_cache.append_span(k, v), pad_mask, rope_q)
            return self._paged_decode_attend(q, kv_cache.append(k, v), pad_mask, rope_q)

        # a span (the prompt pass, or the shared-prefix prefill's suffix):
        # its cache length is a host int, read only then; a device length
        # (the decode step's) is never read back
        span = n_q > 1 and not torch.is_tensor(kv_cache.length)
        new_cache = kv_cache.append(k, v)
        eff_len, cap = new_cache.length, new_cache.capacity
        if span and kv_cache.length == 0 and (not new_cache.quantized or self._prefill_reads_fresh_keys(n_q, n_kv)):
            # prefill: attention over [0, length) IS attention over the fresh
            # keys/values, which occupy slots [0, n_kv)
            fresh_pad = None if pad_mask is None else pad_mask[:, :n_kv]
            o = self._fresh_flash(q, k, v, rope_q, fresh_pad)
            if o is not None:
                return AttentionOutput(self._proj(self.o_proj, o), new_cache)
        elif span and self.packed_route_ok() and not new_cache.quantized:
            # a span over a filled cache: K2 over the filled slots, in the
            # fresh keys' dtype (rows a bf16 layer wrote into an f32 cache
            # come back exactly); an int8 cache takes the dense path below
            span_pad = None if pad_mask is None else pad_mask[:, :eff_len]
            o = self._packed_flash(q, new_cache.k[:, :eff_len].to(k.dtype), new_cache.v[:, :eff_len].to(v.dtype),
                                   rope_q, span_pad)
            return AttentionOutput(self._proj(self.o_proj, o), new_cache)

        kv_idx = torch.arange(cap, device=q.device)
        masked = (kv_idx >= eff_len)[None, None, :]
        if pad_mask is not None:
            masked = masked | pad_mask[:, None, :cap]
        if self.causal_attention:
            masked = masked | self._causal(n_q, cap, eff_len, q.device)
        scales = (new_cache.k_scale, new_cache.v_scale) if new_cache.quantized else None
        fold = self._folds_decode_scales(n_q)
        o = self._dense(q, new_cache.k, new_cache.v, rope_q, masked, scales=scales, fold=fold)
        out = self._proj(self.o_proj, o)
        # JAX's single-query decode route (``fold``'s gate) has no tap
        return AttentionOutput(out if fold else probe("attention.out", out), new_cache)

    @staticmethod
    def _causal(n_q: int, n_kv: int, eff_len: int, device) -> torch.Tensor:
        """(1, Nq, Nkv) True where key j lies after query i's absolute slot
        ``eff_len - n_q + i`` (right-aligned)."""
        q_abs = eff_len - n_q + torch.arange(n_q, device=device)
        kv_idx = torch.arange(n_kv, device=device)
        return (kv_idx[None, :] > q_abs[:, None])[None]
