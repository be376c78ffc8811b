"""Packed flash attention: the forward (K2), the backward (K4a dK/dV, K4b dQ)
and their plain PyTorch versions, joined by a ``torch.autograd.Function``;
its two-segment form (K6 forward, K7a dK/dV, K7b dQ) for the Perceiver AR
cross-attention over ``[prefix; latents]``; the heads-major form (K8
forward, K9a dK/dV, K9b dQ) over ``(B, H, N, D)`` operands with head dims
up to 512; and the kernel feature switch (:func:`fast_kernels`).

Counterpart of ``perceiver_io_tpu/ops/flash_attention.py::flash_attention_packed``
and its custom VJP (``_flash_packed_fwd`` / ``_flash_packed_bwd``), of
``flash_attention_packed_2seg``, of ``flash_attention`` and its custom VJP
(``_flash``), and of ``fast_kernels``. The packed forms keep the projection
layout ``(B, N, H*D)``: a head is a strided column slice.

Semantics (shared by the CUDA kernels ``csrc/flash_packed.cu`` and
``csrc/flash_packed_bwd.cu`` and the plain versions here):

- scores ``s_ij = sm_scale * q_i . k_j + bias_j`` in f32, where the bias row is
  0 or the finite ``MASK_VALUE`` at padded keys;
- ``causal``: right-aligned, query ``i`` sees key ``j`` iff
  ``j <= i + (Nkv - Nq)`` from the unpadded lengths; keys past that limit
  never enter the softmax, and in the backward their ``p`` is exactly 0;
- a row whose visible keys are all padded gets the uniform average of those
  keys' values (finite mask value: not zero, not NaN); a row that sees no key
  at all (only when ``Nq > Nkv``) gets 0 and logsumexp ``-inf``, and a zero
  gradient;
- output in q's dtype, logsumexp ``(B, Nq, H)`` f32;
- the backward recomputes ``p = exp(s - lse)`` from the saved logsumexp, with
  ``delta_i = rowsum(dO_i * O_i)`` per head (f32), ``dV = P^T dO``,
  ``dS = P * (dO V^T - delta) * sm_scale``, ``dK = dS^T Q``, ``dQ = dS K``.
  The bias and the pad mask get no gradient, as in the JAX package.
- bf16 operands (every flash kernel takes them, as the JAX package's
  kernels do): every product takes bf16 operands and sums in f32,
  the softmax and ``delta`` are f32, and the outputs and gradients come out
  in bf16. The backward rounds ``p`` to bf16 before ``dV = P^T dO`` and
  ``dS`` to bf16 before ``dK`` and ``dQ``, where the JAX kernels round them.
  The heads-major forward (K8) rounds ``p`` to bf16 once before ``P V``, as
  the JAX kernel does; the packed and two-segment forwards (K2, K6) keep
  ``p`` in f32 for ``P V`` (their bf16 builds split ``p`` into two bf16
  parts, ~2^-16): a closer answer, within the JAX package's bf16 rounding,
  and the concat and two-segment routes compute the same function.

Dispatch is by device: a CUDA tensor launches the kernels (or raises), a CPU
tensor takes the plain versions. There is no fallback on failure. Every call
goes through :class:`_FlashPacked` (or :class:`_FlashPacked2Seg`,
:class:`_FlashHeads`), whose backward dispatches the same way (under ``no_grad`` it records no graph and
launches the same forward).

The two-segment form computes exactly ``flash_attention_packed(q,
[k_p; k_l], [v_p; v_l], causal=True)`` with the two pad masks joined, without
joining anything: query ``i`` sees the whole prefix and latent slots
``t <= i`` (causal offset 0 in latent-local coordinates), and the kernels read
each segment where it lies. Its kernels take f32 or bf16 operands.

The heads-major form has the same semantics per (batch, head) row; the
wrapper zero-pads odd head dims to a multiple of 8 and slices the extra
output channels off. Its kernels take f32 or bf16 operands.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional, Tuple

import torch

from perceiver_io_tpu_torch.ops import build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's kernel feature names. Only "twoseg" changes anything in
# the port: it routes the cache-free causal prefix cross-attention through the
# two-segment kernels (K6, K7a, K7b). "base2", "nobias", "fastmask" and
# "slimstats" are TPU schedule trims that give the same output within
# rounding, so the Hopper kernels implement only the default semantics; and
# the port's paged decode runs K3 wherever the pools' geometry allows (the
# gather route where the JAX package's kernel refuses the geometry too, or on
# the CPU: core/attention.py), so "paged" has nothing to switch.
# The names are accepted so that a JAX caller's ``fast_kernels(True)`` works.
ALL_FEATURES = frozenset({"base2", "nobias", "fastmask", "slimstats", "twoseg", "paged"})
# a contextvar, not a module global: a scope cannot leak into another thread
_FAST_FEATURES = contextvars.ContextVar("flash_fast_features", default=frozenset())


def _parse_features(mode) -> frozenset:
    if mode is True:
        return ALL_FEATURES
    if mode is False:
        return frozenset()
    unknown = frozenset(mode) - ALL_FEATURES
    if unknown:
        raise ValueError(f"unknown kernel features: {sorted(unknown)}")
    return frozenset(mode)


def fast_features() -> frozenset:
    """The active feature set (empty by default), read at each call."""
    return _FAST_FEATURES.get()


def set_fast_kernels(mode) -> None:
    """Select kernel features for the current context: True = all, False =
    none, or an iterable of names from :data:`ALL_FEATURES`; prefer the
    scoped :func:`fast_kernels`."""
    _FAST_FEATURES.set(_parse_features(mode))


@contextlib.contextmanager
def fast_kernels(mode):
    """Scoped feature selection: calls inside the with-block see ``mode``. A
    route is fixed when the forward runs; a backward run after the block
    still follows it."""
    token = _FAST_FEATURES.set(_parse_features(mode))
    try:
        yield
    finally:
        _FAST_FEATURES.reset(token)


def packed_supported(num_heads: int, d_qk: int, d_v: int) -> bool:
    """Head dims the kernel takes: multiples of 8 up to 128."""
    return num_heads >= 1 and all(d % 8 == 0 and 8 <= d <= 128 for d in (d_qk, d_v))


def bias_row(pad_mask: Optional[torch.Tensor], b: int, nkv: int, device) -> Optional[torch.Tensor]:
    """The additive f32 (B, Nkv) kv bias of a pad mask: 0, or ``MASK_VALUE``
    at padded keys (None without a mask)."""
    if pad_mask is None:
        return None
    if pad_mask.shape != (b, nkv):
        raise ValueError(f"pad_mask must be {(b, nkv)}, got {tuple(pad_mask.shape)}")
    return torch.zeros((b, nkv), dtype=torch.float32, device=device).masked_fill_(pad_mask.to(device), MASK_VALUE)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, N, H, D) in f32 (f64 operands stay f64, so the
    plain versions can be evaluated exactly on f64 copies of f32 inputs)."""
    b, n, c = t.shape
    return (t if t.dtype == torch.float64 else t.float()).reshape(b, n, h, c // h)


def _rounding(dtype: torch.dtype):
    """The backward's rounding of ``p`` and ``dS`` before a gradient
    product: to bf16 and back for bf16 operands (where the JAX kernels cast
    them to the operands' dtype), none for f32 and f64 ones."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).to(x.dtype)
    return lambda x: x


def _visible(nq: int, nkv: int, causal: bool, device) -> Optional[torch.Tensor]:
    """(Nq, Nkv) bool, True where query i sees key j (None: every key)."""
    if not causal:
        return None
    i = torch.arange(nq, device=device)[:, None]
    j = torch.arange(nkv, device=device)[None, :]
    return j <= i + (nkv - nq)


def _scores(q4, k4, bias, sm_scale):
    s = torch.einsum("bihc,bjhc->bhij", q4, k4) * sm_scale
    return s if bias is None else s + bias[:, None, None, :]


def _fwd_plain(q, k, v, num_heads, bias, causal, sm_scale, round_p: bool = False):
    """``round_p``: for bf16 operands, ``p`` rounded to bf16 once before
    ``P V`` (K8's and the JAX kernel's rounding; the row sums stay those of
    the f32 ``p``)."""
    b, nq = q.shape[0], q.shape[1]
    q4, k4, v4 = _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)
    s = _scores(q4, k4, bias, sm_scale)
    visible = _visible(nq, k.shape[1], causal, q.device)
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_use = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_use)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if round_p:
        p = _rounding(q.dtype)(p)
    o = torch.einsum("bhij,bjhc->bihc", p, v4) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].permute(0, 2, 1)  # (B, Nq, H)
    return o.reshape(b, nq, -1).to(q.dtype), lse.contiguous()


def _bwd_plain(q, k, v, o, lse, do, num_heads, bias, causal, sm_scale):
    b, nq, nkv = q.shape[0], q.shape[1], k.shape[1]
    q4, k4, v4 = _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)
    do4, o4 = _heads(do, num_heads), _heads(o, num_heads)
    s = _scores(q4, k4, bias, sm_scale)
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    visible = _visible(nq, nkv, causal, q.device)
    if visible is not None:
        # also drops the NaN of a row that sees nothing (lse = -inf)
        p = torch.where(visible, p, torch.zeros((), device=p.device))
    delta = (do4 * o4).sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, H, Nq, 1)
    rnd = _rounding(q.dtype)
    dv = torch.einsum("bhij,bihc->bjhc", rnd(p), do4)
    ds = rnd(p * (torch.einsum("bihc,bjhc->bhij", do4, v4) - delta) * sm_scale)
    dk = torch.einsum("bhij,bihc->bjhc", ds, q4)
    dq = torch.einsum("bhij,bjhc->bihc", ds, k4)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype))


def flash_attention_packed_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: a masked dense f32 softmax. Returns ``(o, lse)``."""
    bias = bias_row(pad_mask, q.shape[0], k.shape[1], q.device)
    return _fwd_plain(q, k, v, num_heads, bias, causal, sm_scale)


def flash_attention_packed_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward (what K4a and K4b compute): ``(dq, dk, dv)`` from
    the forward's output ``o`` and logsumexp ``lse`` and the output gradient
    ``do``, dense in f32 (``p`` and ``dS`` rounded to bf16 for bf16
    operands)."""
    bias = bias_row(pad_mask, q.shape[0], k.shape[1], q.device)
    return _bwd_plain(q, k, v, o, lse, do, num_heads, bias, causal, sm_scale)


def _check_cuda_operands(tensors, dtypes, what: str) -> None:
    dev = tensors[0].device
    if any(t.dtype not in dtypes or t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{what} takes {' or '.join(str(d) for d in dtypes)} operands of one dtype, got "
                        f"{'/'.join(str(t.dtype) for t in tensors)}")
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{what}: operands must lie on one CUDA device")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned: the kernels read rows as float4."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _head_dims(q, v, num_heads):
    d_qk, d_v = q.shape[2] // num_heads, v.shape[2] // num_heads
    if not packed_supported(num_heads, d_qk, d_v):
        raise ValueError(f"head dims ({d_qk}, {d_v}) must be multiples of 8 up to 128")
    return d_qk, d_v


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kv_splits(bh: int, nq: int, q_rows: int, n_tiles: int, sms: int) -> int:
    """How many CTAs the kv walk of each q block is split across (K2, K6,
    K8, K9b): as many as fill the ``sms`` CTA slots (the card's SMs times
    the kernel's CTAs an SM) that one CTA per q block leaves idle, and no
    more. A split never adds a wave: each split writes a partial the merge
    pass reads back, so it pays only on an SM that would otherwise idle. At
    least 8 tiles a split, at most 64 splits."""
    base = bh * -(-nq // q_rows)
    return max(1, min(sms // base, n_tiles // 8, 64))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def packed_kv_splits(batch: int, num_heads: int, nq: int, nkv: int, d_max: int, sms: int,
                     dtype: torch.dtype = torch.float32) -> int:
    """How many CTAs K2 (and K6, over its two segments' keys) splits each q
    block's kv walk across: :func:`_kv_splits` over their 64-row q blocks,
    two CTA slots an SM (their shared memory allows two at every head dim,
    in both builds) and their kv tiles (``csrc/flash_mma.cuh``: the f32
    build's 64 rows up to head dim 64 and 32 above, the bf16 build's 64).
    The serving prefill (512 latents x 8 heads x batch 1 over 16384 keys)
    takes 4, K6's eval window 2; the training shapes fill the card
    unsplit."""
    kv_rows = 64 if d_max <= 64 or dtype == torch.bfloat16 else 32
    return _kv_splits(batch * num_heads, nq, 64, -(-nkv // kv_rows), 2 * sms)


def _fwd_cuda(q, k, v, num_heads, bias, causal, sm_scale, nsplit: Optional[int] = None):
    """The K2 wrapper; ``nsplit`` forces a kv split (default: the split rule,
    :func:`packed_kv_splits`)."""
    _check_cuda_operands((q, k, v), tuple(_DTYPE_CODES), "flash_attention_packed")
    b, nq, nkv, h = q.shape[0], q.shape[1], k.shape[1], num_heads
    d_qk, d_v = _head_dims(q, v, h)
    q, k, v = _ready(q), _ready(k), _ready(v)
    o = torch.empty((b, nq, h * d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    if nsplit is None:
        nsplit = packed_kv_splits(b, h, nq, nkv, max(d_qk, d_v), _sms(q.device), q.dtype)
    part = torch.empty(nsplit * b * nq * h * (d_v + 2), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    err = build.launcher("flash_packed_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(), lse.data_ptr(), _ptr(part),
        b, nq, nkv, h, d_qk, d_v, int(bool(causal)), float(sm_scale), nsplit,
        _DTYPE_CODES[q.dtype], build.current_stream(q.device),
    )
    build.check(err, "flash_packed_fwd")
    build.count_launch("flash_packed_fwd", q.dtype, kv_rows=nkv)
    return o, lse


def bwd_delta(o: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``delta_i = sum_c dO_ic O_ic`` per head, (B, Nq, H) f32: a PyTorch op
    outside the kernels, as the JAX package computes it in XLA."""
    b, nq, c = o.shape
    return (do.float().reshape(b, nq, num_heads, c // num_heads)
            * o.float().reshape(b, nq, num_heads, c // num_heads)).sum(dim=-1).contiguous()


def _bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale):
    _check_cuda_operands((q, k, v, do), tuple(_DTYPE_CODES), "the packed flash backward")
    b, nq, nkv = q.shape[0], q.shape[1], k.shape[1]
    d_qk, d_v = _head_dims(q, v, num_heads)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, do, lse, delta)) + (None if bias is None else bias.data_ptr(),)
    ints = (b, nq, nkv, num_heads, d_qk, d_v, int(bool(causal)), float(sm_scale), _DTYPE_CODES[q.dtype],
            build.current_stream(q.device))
    return ptrs, ints


def bwd_dkv_cuda(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale):
    """The K4a wrapper: ``(dk, dv)`` for contiguous, aligned operands of one
    dtype (f32 or bf16; the gradients in it), ``lse``/``delta`` (B, Nq, H)
    f32 and the bias row (or None)."""
    ptrs, ints = _bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.check(build.launcher("flash_packed_bwd_dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints),
                "flash_packed_bwd_dkv")
    build.count_launch("flash_packed_bwd_dkv", q.dtype, kv_rows=k.shape[1])
    return dk, dv


def bwd_dq_cuda(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale):
    """The K4b wrapper: ``dq``, for the operands :func:`bwd_dkv_cuda` takes."""
    ptrs, ints = _bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale)
    dq = torch.empty_like(q)
    build.check(build.launcher("flash_packed_bwd_dq")(*ptrs, dq.data_ptr(), *ints), "flash_packed_bwd_dq")
    build.count_launch("flash_packed_bwd_dq", q.dtype, kv_rows=k.shape[1])
    return dq


def _bwd_cuda(q, k, v, o, lse, do, num_heads, bias, causal, sm_scale):
    q, k, v, do = _ready(q), _ready(k), _ready(v), _ready(do)
    args = (q, k, v, do, lse.contiguous(), bwd_delta(o, do, num_heads), num_heads, bias, causal, sm_scale)
    dk, dv = bwd_dkv_cuda(*args)
    return bwd_dq_cuda(*args), dk, dv


class _FlashPacked(torch.autograd.Function):
    """K2 forward, K4a + K4b backward on CUDA tensors; the plain versions on
    CPU tensors. Saves ``q, k, v, o, lse`` (and the bias row); ``lse`` is an
    output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, bias, causal, sm_scale):
        fwd = _fwd_cuda if q.is_cuda else _fwd_plain
        o, lse = fwd(q, k, v, num_heads, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.num_heads, ctx.causal, ctx.sm_scale = num_heads, causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        bwd = _bwd_cuda if do.is_cuda else _bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.num_heads, bias, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


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
        when ``return_lse``. Differentiable in q, k and v.
    """
    bias = bias_row(pad_mask, q.shape[0], k.shape[1], q.device)
    o, lse = _FlashPacked.apply(q, k, v, num_heads, bias, causal, sm_scale)
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# two segments: the Perceiver AR cross-attention over [prefix; latents]
# ---------------------------------------------------------------------------


def _check_2seg(q, k_p, v_p, k_l, v_l, num_heads) -> None:
    """The JAX wrapper's contract errors, then the operand shapes."""
    b, nq, cq = q.shape
    n_p, n_l = k_p.shape[1], k_l.shape[1]
    if n_l != nq:
        raise ValueError(f"latent kv length ({n_l}) must equal query length ({nq})")
    if n_p < 1:
        raise ValueError("two-segment attention requires a non-empty prefix; "
                         "use flash_attention_packed(causal=True) when prefix_len == 0")
    cv = v_l.shape[2]
    want = {"k_prefix": (b, n_p, cq), "v_prefix": (b, n_p, cv), "k_latent": (b, nq, cq)}
    for name, t in zip(want, (k_p, v_p, k_l)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if cq % num_heads or cv % num_heads:
        raise ValueError(f"widths ({cq}, {cv}) must be divisible by num_heads ({num_heads})")


def _joint_bias(bias_p, bias_l, n_p, nq):
    """The plain versions' (B, Np + Nq) bias row (None when neither segment
    has one)."""
    if bias_p is None and bias_l is None:
        return None
    like = bias_p if bias_p is not None else bias_l
    zeros = lambda n: torch.zeros((like.shape[0], n), dtype=torch.float32, device=like.device)  # noqa: E731
    return torch.cat([zeros(n_p) if bias_p is None else bias_p, zeros(nq) if bias_l is None else bias_l], dim=1)


def _fwd_2seg_plain(q, k_p, v_p, k_l, v_l, num_heads, bias_p, bias_l, sm_scale):
    """The plain forward joins the segments: it is the plain version, which
    the kernels are held against."""
    bias = _joint_bias(bias_p, bias_l, k_p.shape[1], q.shape[1])
    return _fwd_plain(q, torch.cat([k_p, k_l], dim=1), torch.cat([v_p, v_l], dim=1), num_heads, bias, True,
                      sm_scale)


def _bwd_2seg_plain(q, k_p, v_p, k_l, v_l, o, lse, do, num_heads, bias_p, bias_l, sm_scale):
    n_p = k_p.shape[1]
    bias = _joint_bias(bias_p, bias_l, n_p, q.shape[1])
    dq, dk, dv = _bwd_plain(q, torch.cat([k_p, k_l], dim=1), torch.cat([v_p, v_l], dim=1), o, lse, do, num_heads,
                            bias, True, sm_scale)
    return dq, dk[:, :n_p], dv[:, :n_p], dk[:, n_p:], dv[:, n_p:]


def _2seg_biases(q, k_p, pad_mask_prefix, pad_mask_latent):
    b, nq = q.shape[0], q.shape[1]
    return bias_row(pad_mask_prefix, b, k_p.shape[1], q.device), bias_row(pad_mask_latent, b, nq, q.device)


def flash_attention_packed_2seg_reference(
    q: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    k_latent: torch.Tensor,
    v_latent: torch.Tensor,
    num_heads: int,
    pad_mask_prefix: Optional[torch.Tensor] = None,
    pad_mask_latent: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain two-segment forward (what K6 computes): ``(o, lse)``, dense
    in f32 over the joined segments."""
    _check_2seg(q, k_prefix, v_prefix, k_latent, v_latent, num_heads)
    bias_p, bias_l = _2seg_biases(q, k_prefix, pad_mask_prefix, pad_mask_latent)
    return _fwd_2seg_plain(q, k_prefix, v_prefix, k_latent, v_latent, num_heads, bias_p, bias_l, sm_scale)


def flash_attention_packed_2seg_bwd_reference(
    q: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    k_latent: torch.Tensor,
    v_latent: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    pad_mask_prefix: Optional[torch.Tensor] = None,
    pad_mask_latent: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """The plain two-segment backward (what K7a and K7b compute):
    ``(dq, dk_prefix, dv_prefix, dk_latent, dv_latent)``."""
    _check_2seg(q, k_prefix, v_prefix, k_latent, v_latent, num_heads)
    bias_p, bias_l = _2seg_biases(q, k_prefix, pad_mask_prefix, pad_mask_latent)
    return _bwd_2seg_plain(q, k_prefix, v_prefix, k_latent, v_latent, o, lse, do, num_heads, bias_p, bias_l,
                           sm_scale)


def _fwd_2seg_cuda(q, k_p, v_p, k_l, v_l, num_heads, bias_p, bias_l, sm_scale):
    _check_cuda_operands((q, k_p, v_p, k_l, v_l), tuple(_DTYPE_CODES), "flash_attention_packed_2seg")
    b, nq, n_p, h = q.shape[0], q.shape[1], k_p.shape[1], num_heads
    d_qk, d_v = _head_dims(q, v_l, h)
    q, k_p, v_p, k_l, v_l = (_ready(t) for t in (q, k_p, v_p, k_l, v_l))
    o = torch.empty((b, nq, h * d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    nsplit = packed_kv_splits(b, h, nq, n_p + nq, max(d_qk, d_v), _sms(q.device), q.dtype)
    part = torch.empty(nsplit * b * nq * h * (d_v + 2), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    err = build.launcher("flash_2seg_fwd")(
        *(t.data_ptr() for t in (q, k_p, v_p, k_l, v_l)), _ptr(bias_p), _ptr(bias_l), o.data_ptr(), lse.data_ptr(),
        _ptr(part), b, nq, n_p, h, d_qk, d_v, float(sm_scale), nsplit, _DTYPE_CODES[q.dtype],
        build.current_stream(q.device),
    )
    build.check(err, "flash_2seg_fwd")
    build.count_launch("flash_2seg_fwd", q.dtype)
    return o, lse


def _bwd_2seg_args(q, k_p, v_p, k_l, v_l, do, lse, delta, num_heads, bias_p, bias_l, sm_scale):
    _check_cuda_operands((q, k_p, v_p, k_l, v_l, do), tuple(_DTYPE_CODES), "the two-segment flash backward")
    d_qk, d_v = _head_dims(q, v_l, num_heads)
    ptrs = tuple(t.data_ptr() for t in (q, k_p, v_p, k_l, v_l, do, lse, delta)) + (_ptr(bias_p), _ptr(bias_l))
    ints = (q.shape[0], q.shape[1], k_p.shape[1], num_heads, d_qk, d_v, float(sm_scale), _DTYPE_CODES[q.dtype],
            build.current_stream(q.device))
    return ptrs, ints


def bwd_2seg_dkv_cuda(q, k_p, v_p, k_l, v_l, do, lse, delta, num_heads, bias_p, bias_l, sm_scale):
    """The K7a wrapper: ``(dk_p, dv_p, dk_l, dv_l)`` for contiguous, aligned
    operands of one dtype (f32 or bf16; the gradients in it), ``lse``/``delta``
    (B, Nq, H) f32 and the two bias rows (or None)."""
    ptrs, ints = _bwd_2seg_args(q, k_p, v_p, k_l, v_l, do, lse, delta, num_heads, bias_p, bias_l, sm_scale)
    outs = tuple(torch.empty_like(t) for t in (k_p, v_p, k_l, v_l))
    build.check(build.launcher("flash_2seg_bwd_dkv")(*ptrs, *(t.data_ptr() for t in outs), *ints),
                "flash_2seg_bwd_dkv")
    build.count_launch("flash_2seg_bwd_dkv", q.dtype)
    return outs


def bwd_2seg_dq_cuda(q, k_p, v_p, k_l, v_l, do, lse, delta, num_heads, bias_p, bias_l, sm_scale):
    """The K7b wrapper: ``dq``, for the operands :func:`bwd_2seg_dkv_cuda`
    takes."""
    ptrs, ints = _bwd_2seg_args(q, k_p, v_p, k_l, v_l, do, lse, delta, num_heads, bias_p, bias_l, sm_scale)
    dq = torch.empty_like(q)
    build.check(build.launcher("flash_2seg_bwd_dq")(*ptrs, dq.data_ptr(), *ints), "flash_2seg_bwd_dq")
    build.count_launch("flash_2seg_bwd_dq", q.dtype)
    return dq


def _bwd_2seg_cuda(q, k_p, v_p, k_l, v_l, o, lse, do, num_heads, bias_p, bias_l, sm_scale):
    q, k_p, v_p, k_l, v_l, do = (_ready(t) for t in (q, k_p, v_p, k_l, v_l, do))
    args = (q, k_p, v_p, k_l, v_l, do, lse.contiguous(), bwd_delta(o, do, num_heads), num_heads, bias_p, bias_l,
            sm_scale)
    dk_p, dv_p, dk_l, dv_l = bwd_2seg_dkv_cuda(*args)
    return bwd_2seg_dq_cuda(*args), dk_p, dv_p, dk_l, dv_l


class _FlashPacked2Seg(torch.autograd.Function):
    """K6 forward, K7a + K7b backward on CUDA tensors; the plain versions on
    CPU tensors. Saves ``q, k_p, v_p, k_l, v_l, o, lse`` and the two bias
    rows; the backward runs the two-segment kernels whatever the feature set
    is by then."""

    @staticmethod
    def forward(ctx, q, k_p, v_p, k_l, v_l, num_heads, bias_p, bias_l, sm_scale):
        fwd = _fwd_2seg_cuda if q.is_cuda else _fwd_2seg_plain
        o, lse = fwd(q, k_p, v_p, k_l, v_l, num_heads, bias_p, bias_l, sm_scale)
        ctx.save_for_backward(q, k_p, v_p, k_l, v_l, o, lse, bias_p, bias_l)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k_p, v_p, k_l, v_l, o, lse, bias_p, bias_l = ctx.saved_tensors
        bwd = _bwd_2seg_cuda if do.is_cuda else _bwd_2seg_plain
        grads = bwd(q, k_p, v_p, k_l, v_l, o, lse, do, ctx.num_heads, bias_p, bias_l, ctx.sm_scale)
        return (*grads, None, None, None, None)


def flash_attention_packed_2seg(
    q: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    k_latent: torch.Tensor,
    v_latent: torch.Tensor,
    num_heads: int,
    pad_mask_prefix: Optional[torch.Tensor] = None,
    pad_mask_latent: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
    return_lse: bool = False,
):
    """Fused causal attention of ``q`` over the logical kv sequence
    ``[prefix; latents]`` without joining the segments: query ``i`` sees the
    whole prefix plus latent slots ``t <= i``, the concat route's
    ``j <= i + Np``.

    :param q: latent queries (B, Nq, H*Dqk), already scaled/rotated.
    :param k_prefix: kept-prefix keys (B, Np, H*Dqk), Np >= 1, already rotated.
    :param v_prefix: kept-prefix values (B, Np, H*Dv).
    :param k_latent: latent keys (B, Nq, H*Dqk), already rotated.
    :param v_latent: latent values (B, Nq, H*Dv).
    :param pad_mask_prefix: (B, Np) bool, True at padded keys, or None.
    :param pad_mask_latent: (B, Nq) bool, True at padded keys, or None.
    :returns: (B, Nq, H*Dv) in q's dtype, and the (B, Nq, H) f32 logsumexp
        when ``return_lse``. Differentiable in q and the four K/V operands.
    """
    _check_2seg(q, k_prefix, v_prefix, k_latent, v_latent, num_heads)
    bias_p, bias_l = _2seg_biases(q, k_prefix, pad_mask_prefix, pad_mask_latent)
    o, lse = _FlashPacked2Seg.apply(q, k_prefix, v_prefix, k_latent, v_latent, num_heads, bias_p, bias_l, sm_scale)
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# heads-major: (B, H, N, D) operands, head dims up to 512
# ---------------------------------------------------------------------------

def flash_supported(d_qk: int, d_v: int) -> bool:
    """Head dims the heads-major kernels take (odd widths are zero-padded to
    a multiple of 8 by :func:`flash_attention`): up to 512. Wider heads take
    the dense path, as the JAX package's ``flash_supported`` sends them; its
    sequence-length floor (128) is not kept: the kernels take any length."""
    return 1 <= d_qk <= 512 and 1 <= d_v <= 512


def _heads_bias(bias, num_heads):
    """The plain versions' (B*H, Nkv) bias rows."""
    return None if bias is None else bias.repeat_interleave(num_heads, dim=0)


def _heads_fwd_plain(q, k, v, num_heads, bias, causal, sm_scale):
    """(B*H, N, D) operands as B*H batch rows of one head each; ``p``
    rounded to bf16 before ``P V`` for bf16 operands, as K8 and the JAX
    kernel round it."""
    o, lse = _fwd_plain(q, k, v, 1, _heads_bias(bias, num_heads), causal, sm_scale, round_p=True)
    return o, lse[..., 0]


def _heads_bwd_plain(q, k, v, o, lse, do, num_heads, bias, causal, sm_scale):
    return _bwd_plain(q, k, v, o, lse[..., None], do, 1, _heads_bias(bias, num_heads), causal, sm_scale)


def _heads_layout(q, k, v):
    """(B, H, N, D) -> contiguous (B*H, N, D8), D zero-padded to a multiple of
    8 (zero qk channels add nothing to a score; zero v channels give output
    channels that are sliced off)."""
    def flat(t):
        b, h, n, d = t.shape
        t = t.reshape(b * h, n, d)
        return torch.nn.functional.pad(t, (0, -d % 8)) if d % 8 else t
    return flat(q), flat(k), flat(v)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain heads-major forward (what K8 computes), dense in f32 (``p``
    rounded to bf16 before ``P V`` for bf16 operands): ``(o (B, H, Nq, Dv),
    lse (B, H, Nq))``, ``o`` in q's dtype."""
    b, h, nq, _ = q.shape
    bias = bias_row(pad_mask, b, k.shape[2], q.device)
    o, lse = _heads_fwd_plain(*(t.reshape(b * h, t.shape[2], t.shape[3]) for t in (q, k, v)), h, bias, causal,
                              sm_scale)
    return o.reshape(b, h, nq, -1), lse.reshape(b, h, nq)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain heads-major backward (what K9a and K9b compute): ``(dq, dk,
    dv)`` from the forward's ``o`` and ``lse`` and the output gradient ``do``,
    all in the (B, H, N, D) layout (``p`` and ``dS`` rounded to bf16 for
    bf16 operands)."""
    b, h = q.shape[0], q.shape[1]
    bias = bias_row(pad_mask, b, k.shape[2], q.device)
    flat = [t.reshape(b * h, t.shape[2], t.shape[3]) for t in (q, k, v, o)]
    grads = _heads_bwd_plain(*flat, lse.reshape(b * h, -1), do.reshape(flat[3].shape), h, bias, causal,
                             sm_scale)
    return tuple(g.reshape(t.shape) for g, t in zip(grads, (q, k, v)))


def _heads_dims(dqk: int, dv: int) -> None:
    if not all(d % 8 == 0 and 8 <= d <= 512 for d in (dqk, dv)):
        raise ValueError(f"heads-major kernels take head dims that are multiples of 8 up to 512, got {(dqk, dv)}")


def heads_fwd_tiles(d_max: int) -> Tuple[int, int]:
    """K8's (q rows a CTA owns, kv rows of a walked tile) at the head-dim
    bucket of ``d_max`` (``Cfg`` and, for the bf16 build, ``Cfg16`` in
    ``csrc/flash_heads.cu``; the two builds tile alike): 64 and 48 up to
    head dim 288 (the image CA's 264), 64 and 16 above."""
    return (64, 48) if d_max <= 288 else (64, 16)


def heads_fwd_splits(bh: int, nq: int, nkv: int, d_max: int, sms: int, slots: int) -> int:
    """How many CTAs K8 splits each q block's kv walk across:
    :func:`_kv_splits` over its q blocks and kv tiles
    (:func:`heads_fwd_tiles`) and ``slots`` CTAs an SM (the build's own
    count from the runtime, :func:`_heads_fwd_slots`; the f32 build takes
    one at the image CA's head dim 264: 200,576 bytes of shared memory a
    CTA). The image CA in f32: 16 x 8 q blocks at batch 16 fill 128 of 132
    SMs unsplit; 2 x 8 at batch 2 take 8 splits."""
    q_rows, kv_rows = heads_fwd_tiles(d_max)
    return _kv_splits(bh, nq, q_rows, -(-nkv // kv_rows), slots * sms)


@functools.lru_cache(maxsize=None)
def _heads_slots(name: str, device_index: int, dqk: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    """CTA slots an SM of K8 (``name`` "flash_heads_fwd") or K9b
    ("flash_heads_bwd_dq") at these head dims, for the build of ``dtype``
    (f32 or bf16: each has its own tiles and registers), from the
    runtime."""
    with torch.cuda.device(device_index):
        slots = build.launcher(f"{name}_slots")(dqk, dv, _DTYPE_CODES[dtype])
    if slots < 1:
        raise RuntimeError(f"{name}: no CTA slot at head dims ({dqk}, {dv}), {dtype} (CUDA error {-slots})")
    return slots


def _heads_fwd_slots(device_index: int, dqk: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    return _heads_slots("flash_heads_fwd", device_index, dqk, dv, dtype)


def heads_fwd_cuda(q, k, v, num_heads, bias, causal, sm_scale, nsplit: Optional[int] = None):
    """The K8 wrapper: ``(o, lse)`` for (B*H, N, D) operands of one dtype
    (f32 or bf16; ``o`` in it, ``lse`` f32) with D a multiple of 8 up to 512
    and the (B, Nkv) bias row (or None); the kv walk split by
    :func:`heads_fwd_splits` unless ``nsplit`` is given."""
    _check_cuda_operands((q, k, v), tuple(_DTYPE_CODES), "flash_attention")
    bh, nq, dqk = q.shape
    nkv, dv = k.shape[1], v.shape[2]
    _heads_dims(dqk, dv)
    q, k, v = _ready(q), _ready(k), _ready(v)
    o = torch.empty((bh, nq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    if nsplit is None:
        nsplit = heads_fwd_splits(bh, nq, nkv, max(dqk, dv), _sms(q.device),
                                  _heads_fwd_slots(q.device.index, dqk, dv, q.dtype))
    part = torch.empty(nsplit * bh * nq * (dv + 2), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    err = build.launcher("flash_heads_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(), lse.data_ptr(), _ptr(part),
        bh, nq, nkv, num_heads, dqk, dv, int(bool(causal)), float(sm_scale), nsplit, _DTYPE_CODES[q.dtype],
        build.current_stream(q.device),
    )
    build.check(err, "flash_heads_fwd")
    build.count_launch("flash_heads_fwd", q.dtype)
    return o, lse


def _heads_bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale):
    _check_cuda_operands((q, k, v, do), tuple(_DTYPE_CODES), "the heads-major flash backward")
    bh, nq, dqk = q.shape
    nkv, dv = k.shape[1], v.shape[2]
    _heads_dims(dqk, dv)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, do, lse, delta)) + (_ptr(bias),)
    return ptrs, (bh, nq, nkv, num_heads, dqk, dv, int(bool(causal)), float(sm_scale))


def heads_bwd_dkv_cuda(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale):
    """The K9a wrapper: ``(dk, dv)`` for contiguous, aligned (B*H, N, D)
    operands of one dtype (f32 or bf16; the gradients in it), ``lse``/
    ``delta`` (B*H, Nq) f32 and the bias row (or None)."""
    ptrs, ints = _heads_bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.check(build.launcher("flash_heads_bwd_dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints,
                                                      _DTYPE_CODES[q.dtype], build.current_stream(q.device)),
                "flash_heads_bwd_dkv")
    build.count_launch("flash_heads_bwd_dkv", q.dtype)
    return dk, dv


def heads_dq_splits(bh: int, nq: int, nkv: int, d_max: int, sms: int, slots: int) -> int:
    """How many CTAs K9b splits each q block's kv walk across:
    :func:`_kv_splits` over its q blocks and kv tiles (32 rows up to head
    dim 288, 16 above: ``csrc/flash_heads_bwd.cu``) and ``slots`` CTAs an SM
    (the build's own count from the runtime; the f32 build takes one at the
    image CA's head dim 264: 232,192 bytes of shared memory a CTA; both
    builds walk the same tiles). A split's partial (1.1 MB at the image CA's batch 2) is written
    once and read once by the merge, which the rule does not charge: on an
    H100 the four splits at batch 2 cut K9b to a quarter of its unsplit time
    (``PERF.md``). The image CA: 16 x 16 q blocks at batch 16 fill the card
    unsplit; 2 x 16 at batch 2 take 4 splits."""
    rows = 32 if d_max <= 288 else 16
    return _kv_splits(bh, nq, rows, -(-nkv // rows), slots * sms)


def _heads_dq_slots(device_index: int, dqk: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    return _heads_slots("flash_heads_bwd_dq", device_index, dqk, dv, dtype)


def heads_bwd_dq_cuda(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale, nsplit: Optional[int] = None):
    """The K9b wrapper: ``dq``, for the operands :func:`heads_bwd_dkv_cuda`
    takes; the kv walk split by :func:`heads_dq_splits` unless ``nsplit``
    is given."""
    ptrs, ints = _heads_bwd_args(q, k, v, do, lse, delta, num_heads, bias, causal, sm_scale)
    bh, nq, dqk = q.shape
    dv = v.shape[2]
    if nsplit is None:
        nsplit = heads_dq_splits(bh, nq, k.shape[1], max(dqk, dv), _sms(q.device),
                                 _heads_dq_slots(q.device.index, dqk, dv, q.dtype))
    dq = torch.empty_like(q)
    part = torch.empty((nsplit, bh, nq, dqk), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    build.check(build.launcher("flash_heads_bwd_dq")(*ptrs, dq.data_ptr(), _ptr(part), *ints, nsplit,
                                                     _DTYPE_CODES[q.dtype], build.current_stream(q.device)),
                "flash_heads_bwd_dq")
    build.count_launch("flash_heads_bwd_dq", q.dtype)
    return dq


def _heads_bwd_cuda(q, k, v, o, lse, do, num_heads, bias, causal, sm_scale):
    q, k, v, do = _ready(q), _ready(k), _ready(v), _ready(do)
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()  # (B*H, Nq) f32, outside the kernels as in JAX
    args = (q, k, v, do, lse.contiguous(), delta, num_heads, bias, causal, sm_scale)
    dk, dv = heads_bwd_dkv_cuda(*args)
    return heads_bwd_dq_cuda(*args), dk, dv


class _FlashHeads(torch.autograd.Function):
    """K8 forward, K9a + K9b backward on CUDA tensors; the plain versions on
    CPU tensors. Operands (B*H, N, D); saves ``q, k, v, o, lse`` and the
    (B, Nkv) bias row; ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, bias, causal, sm_scale):
        fwd = heads_fwd_cuda if q.is_cuda else _heads_fwd_plain
        o, lse = fwd(q, k, v, num_heads, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.num_heads, ctx.causal, ctx.sm_scale = num_heads, causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        bwd = _heads_bwd_cuda if do.is_cuda else _heads_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.num_heads, bias, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float = 1.0,
    return_lse: bool = False,
):
    """Fused attention over heads-major tensors.

    :param q: queries (B, H, Nq, Dqk), already scaled/rotated.
    :param k: keys (B, H, Nkv, Dqk).
    :param v: values (B, H, Nkv, Dv); Dqk and Dv up to 512, any width (odd
        widths are zero-padded to a multiple of 8 and the extra output
        channels sliced off).
    :param pad_mask: (B, Nkv) bool, True at padded keys.
    :param causal: the right-aligned causal mask ``j <= i + (Nkv - Nq)``.
    :returns: (B, H, Nq, Dv) in q's dtype, and the (B, H, Nq) f32 logsumexp
        when ``return_lse``. Differentiable in q, k and v.
    """
    b, h, nq, _ = q.shape
    d_v = v.shape[3]
    if not flash_supported(q.shape[3], d_v):
        raise ValueError(f"head dims ({q.shape[3]}, {d_v}) exceed the heads-major kernels' 512")
    bias = bias_row(pad_mask, b, k.shape[2], q.device)
    o, lse = _FlashHeads.apply(*_heads_layout(q, k, v), h, bias, causal, sm_scale)
    o = o[..., :d_v].reshape(b, h, nq, d_v).to(q.dtype)
    return (o, lse.reshape(b, h, nq)) if return_lse else o
