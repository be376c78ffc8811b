"""Perceiver IO and Perceiver AR in PyTorch (counterpart of
``perceiver_io_tpu/core/modules.py``: ``CrossAttention``, ``SelfAttention``,
``MLP``, the attention layers, ``SelfAttentionBlock``, ``PerceiverEncoder``,
``PerceiverDecoder``, ``PerceiverIO``, ``PerceiverAR`` and
``CausalSequenceModel``).

The module tree reproduces the reference PyTorch implementation's parameter
names (``cross_attention.0.module.q_norm.weight``,
``self_attention.{i}.1.module.3.weight``, ``output_adapter.bias``,
``0.cross_attn_1.0.module.attention.k_proj.weight``, ...), so the weight
bridges of ``convert`` are renamings of the JAX trees and a reference
checkpoint's ``state_dict`` loads as it is.

The cache-free forward is differentiable and takes the training arguments
(``deterministic``, ``prefix_keep_idx``, ``generator``) and every training
option of the JAX package's configs:

- cross-attention prefix dropout in its three modes: ``"gather"`` (the
  compact route for an unpadded batch, the embedded-row gather for a
  left-padded one), ``"gather_embed"`` (the embedded-row gather always) and
  ``"mask"`` (the full prefix, the dropped rows joining the cross-attention's
  pad mask);
- dropout on the attention probabilities (``post_attention_dropout``, the
  encoder's and decoder's ``dropout``) and on the residual branches
  (``residual_dropout``), Flax's ``nn.Dropout`` (``core.dropout``): a layer
  draws its masks from ``generator`` when it is entered;
- activation checkpointing and offloading per attention layer
  (``core.remat``).

Calls with a KV cache (prefill and decode) are inference only and run under
``torch.no_grad()``.

Under ``fast_kernels({"twoseg"})`` (``ops.flash_attention``; off by default,
as in the JAX package) every cache-free causal cross-attention with a
non-empty prefix takes the two-segment route, training and eval forwards
alike: the kept prefix and the latents go to the kernels as separate K/V
operands, and neither ``[kv_norm(prefix); q_norm(latents)]`` nor its
projections, rotary rows or pad flags are ever joined. Calls with a KV cache,
and an empty prefix, keep the concat route.

``dtype`` is the compute dtype of the Perceiver AR and Perceiver IO modules
(Flax's module ``dtype``; ``CausalSequenceModel(config, dtype=torch.bfloat16)``
is the JAX package's ``CausalLanguageModel(config, dtype=jnp.bfloat16)``, and
the image classifier's ``dtype`` reaches ``PerceiverEncoder`` and
``PerceiverDecoder`` the same way): parameters stay f32; projections, MLPs,
the tied logits and the classification head compute in ``dtype``
(:func:`core.attention.dense`), the embeddings and the trainable query
arrays are cast to it, the residual stream stays in it, LayerNorm keeps f32
statistics and writes ``dtype``, RoPE rotates in f32 and casts back, and
attention scores and softmax are f32. The f32 default is the f32 path as it
was.

The Perceiver IO encoder's cross-attention takes the fused split-kv route
whenever its gate allows (an input adapter that splits, no pad mask, one
head, no dropout or checkpointing, head dims the heads-major kernels take):
the constant position features fold through the kv LayerNorm into the K/V
projections (:meth:`CrossAttention.split_kv_projection`), so the
concatenated (B, M, C) input and its LayerNorm output are never built.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_tpu_torch.core.adapter import (
    TiedTokenOutputAdapter,
    TokenInputAdapterWithRotarySupport,
    TrainableQueryProvider,
)
from perceiver_io_tpu_torch.core.attention import AttentionOutput, MultiHeadAttention, dense
from perceiver_io_tpu_torch.core.cache import KVCache, PagedKVCache, init_kv_cache, init_paged_kv_cache
from perceiver_io_tpu_torch.core.config import CausalSequenceModelConfig
from perceiver_io_tpu_torch.core.dropout import dropout as apply_dropout
from perceiver_io_tpu_torch.core.dropout import keep_mask
from perceiver_io_tpu_torch.core.position import positions
from perceiver_io_tpu_torch.core.remat import OffloadArena, remat_mode
from perceiver_io_tpu_torch.core.remat import run as run_remat
from perceiver_io_tpu_torch.device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.obs.probes import probe
from perceiver_io_tpu_torch.ops.flash_attention import fast_features, flash_attention, flash_supported
from perceiver_io_tpu_torch.ops.layernorm import FusedLayerNorm

LAYER_NORM_EPSILON = 1e-5

# channel-pad rounding of the fused split-kv input route: the encoder's gate
# must predict exactly the padded head dims split_kv_projection emits and
# call_with_split_kv hands to flash_attention
SPLIT_KV_PAD = 8


def split_padded(n: int) -> int:
    """Channel width after the split-kv route's zero-padding."""
    return n + (-n) % SPLIT_KV_PAD


class CausalModelOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    logits: torch.Tensor
    kv_cache: Optional[Tuple] = None


class Residual(nn.Module):
    """Holds one sub-module under ``.module`` (the reference naming); the
    layers add the residual themselves."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


def _split_rows(t, n_p: int):
    """The (prefix, latent) parts of a ``[prefix; latents]`` row tensor, which
    may arrive split already as a pair; None gives (None, None)."""
    if t is None:
        return None, None
    return t if isinstance(t, tuple) else (t[:, :n_p], t[:, n_p:])


def _joined_rows(t):
    """A ``[prefix; latents]`` row tensor from a (prefix, latent) pair; a
    tensor or None passes through."""
    return torch.cat(t, dim=1) if isinstance(t, tuple) else t


class CrossAttention(nn.Module):
    """Pre-layer-norm cross-attention. With ``x_kv_prefix`` instead of
    ``x_kv`` the key/value input is ``[kv_norm(prefix); q_norm(x_q)]`` — the
    latents attend to themselves at the end of the sequence (Perceiver AR).
    In that mode ``rope_k`` and ``pad_mask`` cover those rows, each as one
    tensor or as a (prefix, latent) pair."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 causal_attention: bool = False, qkv_bias: bool = True, out_bias: bool = True,
                 num_qk_channels: Optional[int] = None, num_v_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.q_norm = FusedLayerNorm(num_q_input_channels, LAYER_NORM_EPSILON)
        self.kv_norm = FusedLayerNorm(num_kv_input_channels, LAYER_NORM_EPSILON)
        self.attention = MultiHeadAttention(
            num_heads, num_q_input_channels, num_kv_input_channels, num_qk_channels, num_v_channels,
            causal_attention=causal_attention, qkv_bias=qkv_bias, out_bias=out_bias, dtype=dtype,
            dropout=dropout,
        )

    def split_kv_projection(self, x_pix: torch.Tensor, enc: torch.Tensor):
        """K/V of ``kv_norm([x_pix | enc])`` without building the joined
        input or its LayerNorm output, in the compute dtype ``dt`` of the
        attention.

        ``x_pix`` (B, M, P) is the per-example part (pixels), ``enc`` (M, F)
        a per-position constant (the Fourier features). With the LayerNorm
        row ``z = gamma * (x - mu) * r + beta`` and a projection ``W, b``:
        ``z @ W + b = r * (x @ Wg) - (mu * r) * colsum(Wg) + (beta @ W + b)``
        with ``Wg = diag(gamma) @ W``, and ``x @ Wg = pix @ Wg[:P] + enc @
        Wg[P:]``, the second term shared by the batch; the row statistics come
        from pixel sums plus constants of ``enc``. Outputs are zero-padded to
        a multiple of ``SPLIT_KV_PAD`` channels through the weights.

        As the JAX package computes it: the row statistics in f32; ``r``,
        ``mean * r``, ``colsum(Wg)`` and ``beta @ W + b`` cast to ``dt``; the
        two products ``x_pix @ Wg[:P]`` and ``enc @ Wg[P:]`` on ``dt``
        operands; the rest in ``dt``. In f32 every cast is the identity.

        Returns ``(k, v, k_pad, v_pad)``, k/v (B, M, channels + pad) in
        ``dt``."""
        mha = self.attention
        dt = mha.dtype
        n_pix, c = x_pix.shape[-1], self.kv_norm.weight.shape[0]
        gamma, beta = self.kv_norm.weight.float(), self.kv_norm.bias.float()
        enc32, pix32 = enc.float(), x_pix.float()
        s1 = pix32.sum(-1) + enc32.sum(-1)[None]  # (B, M)
        s2 = (pix32 * pix32).sum(-1) + (enc32 * enc32).sum(-1)[None]
        mean = s1 / c
        r = torch.rsqrt(torch.clamp(s2 / c - mean * mean, min=0.0) + self.kv_norm.eps)
        r_col, mr_col = r.to(dt)[..., None], (mean * r).to(dt)[..., None]
        enc_dt, pix_dt = enc.to(dt), x_pix.to(dt)

        def project(linear: nn.Linear, out_ch: int):
            w = linear.weight.float().t()  # (C, out)
            b = linear.bias.float() if linear.bias is not None else torch.zeros(out_ch, device=w.device)
            pad = split_padded(out_ch) - out_ch
            wg = w * gamma[:, None]
            if pad:
                wg, w, b = F.pad(wg, (0, pad)), F.pad(w, (0, pad)), F.pad(b, (0, pad))
            xw = pix_dt @ wg[:n_pix].to(dt) + (enc_dt @ wg[n_pix:].to(dt))[None]
            return xw * r_col - mr_col * wg.sum(0).to(dt) + (beta @ w + b).to(dt), pad

        k, k_pad = project(mha.k_proj, mha.qk_channels)
        v, v_pad = project(mha.v_proj, mha.v_channels)
        return k, v, k_pad, v_pad

    def _two_segment_ok(self, x_kv_prefix, kv_cache, attn_keep) -> bool:
        """The gate of the two-segment route (JAX's
        ``CrossAttention._two_segment_ok``): "twoseg" is on, no KV cache, a
        causal layer, a non-empty prefix, no active dropout on the attention
        probabilities, and head dims the packed kernels take. When False the
        concat route runs unchanged."""
        return ("twoseg" in fast_features() and kv_cache is None and self.attention.causal_attention
                and x_kv_prefix.shape[1] >= 1 and attn_keep is None and self.attention.packed_route_ok())

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache=None, attn_keep=None) -> AttentionOutput:
        """``attn_keep``: the keep mask of an active dropout on the attention
        probabilities (``MultiHeadAttention.forward``)."""
        x_q = self.q_norm(x_q)
        if x_kv is None:
            if self._two_segment_ok(x_kv_prefix, kv_cache, attn_keep):
                n_p = x_kv_prefix.shape[1]
                pad_p, pad_l = _split_rows(pad_mask, n_p)
                rope_p, rope_l = _split_rows(rope_k, n_p)
                return self.attention.two_segment(x_q, self.kv_norm(x_kv_prefix), pad_p, pad_l, rope_q, rope_p,
                                                  rope_l)
            pad_mask, rope_k = _joined_rows(pad_mask), _joined_rows(rope_k)
            # an empty prefix (the decode step) needs no kv_norm launch
            x_kv = x_q if x_kv_prefix.shape[1] == 0 else torch.cat([self.kv_norm(x_kv_prefix), x_q], dim=1)
        else:
            x_kv = self.kv_norm(x_kv)
        return self.attention(x_q, x_kv, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache,
                              attn_keep=attn_keep)


class SelfAttention(nn.Module):
    """Pre-layer-norm self-attention."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False,
                 qkv_bias: bool = True, out_bias: bool = True, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None, dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.norm = FusedLayerNorm(num_channels, LAYER_NORM_EPSILON)
        self.attention = MultiHeadAttention(
            num_heads, num_channels, num_channels, num_qk_channels, num_v_channels,
            causal_attention=causal_attention, qkv_bias=qkv_bias, out_bias=out_bias, dtype=dtype,
            dropout=dropout,
        )

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None, kv_cache=None, attn_keep=None) -> AttentionOutput:
        x = self.norm(x)
        return self.attention(x, x, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache,
                              attn_keep=attn_keep)


class MLP(nn.Sequential):
    """LayerNorm -> Linear(widening * C) -> GELU (exact) -> Linear(C), the
    Linears in the compute ``dtype``."""

    def __init__(self, num_channels: int, widening_factor: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            FusedLayerNorm(num_channels, LAYER_NORM_EPSILON),
            nn.Linear(num_channels, widening_factor * num_channels, bias=bias),
            nn.GELU(),
            nn.Linear(widening_factor * num_channels, num_channels, bias=bias),
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(self[1], self[0](x), self.dtype)
        return dense(self[3], self[2](x), self.dtype)


class _LayerOptions:
    """The training options of an attention layer: residual dropout and the
    remat mode (``core.remat``, set by the module that owns the layer), and
    the keep masks of one call, drawn at its entry (``core.dropout``)."""

    residual_dropout: float = 0.0
    remat = None  # (mode, OffloadArena) or None

    def set_remat(self, mode: Optional[str], arena: OffloadArena) -> None:
        self.remat = None if mode is None else (mode, arena)

    def _draws(self, mha: MultiHeadAttention, x_q: torch.Tensor, n_kv: int, deterministic: bool,
               generator, attention: bool = True, residuals: int = 2) -> tuple:
        """(attention probabilities' keep mask, the residual branches' keep
        masks), in that order, None where a dropout is inactive."""
        if deterministic:
            return (None,) * (1 + residuals)
        if attention and mha.dropout > 0.0 and mha.tensor_size > 1:
            # a rank holds num_heads / tensor heads: it cannot draw its block
            # of JAX's mask over every head (ROADMAP §C)
            raise NotImplementedError("dropout on the attention probabilities of a tensor-parallel layer: set the "
                                      "attention dropout to 0 or shard without tensor parallelism")
        b, n, dev = x_q.shape[0], x_q.shape[1], x_q.device
        attn = keep_mask(mha, 0, (b, mha.num_heads, n, n_kv), mha.dropout, generator, dev) if attention else None
        res = tuple(keep_mask(self, i, x_q.shape, self.residual_dropout, generator, dev) for i in range(residuals))
        return (attn,) + res


class CrossAttentionLayer(_LayerOptions, nn.Sequential):
    """Cross-attention + MLP, each with a residual; without
    ``attention_residual`` the attention output replaces the query input
    (the reference then holds the attention unwrapped, as ``0`` not
    ``0.module``). ``dropout`` drops attention probabilities,
    ``residual_dropout`` both residual branches."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 causal_attention: bool = False, widening_factor: int = 1, qkv_bias: bool = True,
                 out_bias: bool = True, mlp_bias: bool = True, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None, attention_residual: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0, residual_dropout: float = 0.0):
        cross_attn = CrossAttention(num_heads, num_q_input_channels, num_kv_input_channels, causal_attention,
                                    qkv_bias, out_bias, num_qk_channels, num_v_channels, dtype, dropout)
        super().__init__(
            Residual(cross_attn) if attention_residual else cross_attn,
            Residual(MLP(num_q_input_channels, widening_factor, mlp_bias, dtype)),
        )
        self.attention_residual = attention_residual
        self.residual_dropout = residual_dropout

    @property
    def cross_attn(self) -> CrossAttention:
        return self[0].module if self.attention_residual else self[0]

    def _residuals(self, x_q, h_attn, res_keeps) -> torch.Tensor:
        rate = self.residual_dropout
        if self.attention_residual:
            h = x_q + apply_dropout(h_attn, res_keeps[0], rate)
            res_keeps = res_keeps[1:]
        else:
            h = h_attn
        return h + apply_dropout(self[1].module(h), res_keeps[0], rate)

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache=None, deterministic: bool = True, generator=None) -> AttentionOutput:
        n_kv = x_kv.shape[1] if x_kv is not None else x_kv_prefix.shape[1] + x_q.shape[1]
        attn_keep, *res_keeps = self._draws(self.cross_attn.attention, x_q, n_kv, deterministic, generator,
                                            residuals=1 + self.attention_residual)
        if kv_cache is not None and (attn_keep is not None or any(k is not None for k in res_keeps)):
            raise ValueError("dropout applies to cache-free forwards, not to calls with a KV cache")
        return run_remat(self.remat, self._body, x_q, x_kv, x_kv_prefix, pad_mask, rope_q, rope_k, kv_cache,
                         attn_keep, *res_keeps)

    def _body(self, x_q, x_kv, x_kv_prefix, pad_mask, rope_q, rope_k, kv_cache, attn_keep, *res_keeps):
        attn = self.cross_attn(x_q, x_kv, x_kv_prefix, pad_mask, rope_q, rope_k, kv_cache, attn_keep)
        return AttentionOutput(self._residuals(x_q, attn.last_hidden_state, res_keeps), attn.kv_cache)

    def call_with_split_kv(self, x_q, x_pix, enc, deterministic: bool = True, generator=None) -> AttentionOutput:
        """The whole layer with k/v from
        :meth:`CrossAttention.split_kv_projection` and one head through the
        heads-major kernel (the encoder's fused input route: no pad mask, one
        head, no attention-probability dropout or remat;
        ``PerceiverEncoder`` gates it). Numerically ``forward`` on
        ``[x_pix | enc]``, residual dropout included. In bf16 the query, the
        zero-padded k/v and the output are bf16 (K8, K9a and K9b's bf16
        builds on the card)."""
        ca = self.cross_attn
        mha = ca.attention
        _, *res_keeps = self._draws(mha, x_q, 0, deterministic, generator, attention=False,
                                    residuals=1 + self.attention_residual)
        k, v, k_pad, v_pad = ca.split_kv_projection(x_pix, enc)
        q = mha.project_q(ca.q_norm(x_q))  # (B, 1, N, Dk), scaled
        if k_pad:
            q = F.pad(q, (0, k_pad))
        o = flash_attention(q, k[:, None], v[:, None])
        if v_pad:
            o = o[..., : mha.v_channels]
        return AttentionOutput(self._residuals(x_q, mha.merge_output(o), res_keeps), None)

    def seq_parallel(self, x_q, x_kv_prefix_local, rope_q, rope_k_prefix, mask_prefix, group) -> torch.Tensor:
        """The causal prefix cross-attention layer with the prefix sharded
        over ``group`` (``PerceiverAR.seq_parallel_forward``; the JAX
        package's hand-wired block): the kv input is
        ``[kv_norm(prefix); q_norm(latents)]`` as in ``forward``; this rank's
        prefix block is attended without a causal mask (every prefix
        position precedes every latent), LSE-combined across the group, and
        merged with the replicated causal latent partial by the online
        combine; then the residuals and the MLP, without dropout.
        ``mask_prefix`` (B, P_local): True where a prefix row is masked out."""
        from perceiver_io_tpu_torch.ops.online_softmax import block_attention, finalize, online_combine
        from perceiver_io_tpu_torch.parallel.ring_attention import seq_sharded_cross_attention

        ca = self.cross_attn
        mha = ca.attention
        q_in = ca.q_norm(x_q)
        q = mha.project_q(q_in, rope_q)
        k_p, v_p = mha.project_kv(ca.kv_norm(x_kv_prefix_local), rope_k_prefix)
        k_l, v_l = mha.project_kv(q_in, rope_q)
        o_p, m_glob, l_p = seq_sharded_cross_attention(q, k_p, v_p, mask_prefix, group=group, causal=False,
                                                       finalize_output=False)
        n = x_q.shape[1]
        lat = torch.arange(n, device=x_q.device)
        o_l, m_l, l_l = block_attention(q, k_l, v_l, lat[None, None, None, :] > lat[None, None, :, None])
        o, _, l = online_combine((o_p, m_glob, l_p), (o_l, m_l, l_l))
        h = x_q + mha.merge_output(finalize(o, l).to(x_q.dtype))
        return h + self[1].module(h)


class SelfAttentionLayer(_LayerOptions, nn.Sequential):
    """Self-attention + MLP, each with a residual; ``dropout`` drops
    attention probabilities, ``residual_dropout`` both residual branches."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False,
                 widening_factor: int = 1, qkv_bias: bool = True, out_bias: bool = True,
                 mlp_bias: bool = True, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, residual_dropout: float = 0.0):
        super().__init__(
            Residual(SelfAttention(num_heads, num_channels, causal_attention, qkv_bias, out_bias, num_qk_channels,
                                   num_v_channels, dtype, dropout)),
            Residual(MLP(num_channels, widening_factor, mlp_bias, dtype)),
        )
        self.residual_dropout = residual_dropout

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None, kv_cache=None, deterministic: bool = True,
                generator=None) -> AttentionOutput:
        attn_keep, res0, res1 = self._draws(self[0].module.attention, x, x.shape[1], deterministic, generator)
        if kv_cache is not None and not (attn_keep is None and res0 is None):
            raise ValueError("dropout applies to cache-free forwards, not to calls with a KV cache")
        return run_remat(self.remat, self._body, x, pad_mask, rope_q, rope_k, kv_cache, attn_keep, res0, res1)

    def _body(self, x, pad_mask, rope_q, rope_k, kv_cache, attn_keep, res0, res1):
        attn = self[0].module(x, pad_mask, rope_q, rope_k, kv_cache, attn_keep)
        h = x + apply_dropout(attn.last_hidden_state, res0, self.residual_dropout)
        h = h + apply_dropout(self[1].module(h), res1, self.residual_dropout)
        return AttentionOutput(h, attn.kv_cache)


class SelfAttentionBlock(nn.Sequential):
    """Stack of self-attention layers with per-layer KV caches; layer ``i``
    gets RoPE iff ``i < num_rotary_layers`` (-1 = every layer)."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int, num_rotary_layers: int = 1,
                 causal_attention: bool = False, widening_factor: int = 1, qkv_bias: bool = True,
                 out_bias: bool = True, mlp_bias: bool = True, num_qk_channels: Optional[int] = None,
                 num_v_channels: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, residual_dropout: float = 0.0):
        super().__init__(*[
            SelfAttentionLayer(num_heads, num_channels, causal_attention, widening_factor,
                               qkv_bias, out_bias, mlp_bias, num_qk_channels, num_v_channels, dtype,
                               dropout, residual_dropout)
            for _ in range(num_layers)
        ])
        self.num_rotary_layers = num_rotary_layers

    # the probe sites' scope prefix, ``{probe_name}.layer_{i}``: the JAX
    # block's module name (``PerceiverAR`` names its block ``self_attention``)
    probe_name = "self_attn"

    def set_remat(self, mode: Optional[str], arena: OffloadArena) -> None:
        for layer in self:
            layer.set_remat(mode, arena)

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None, kv_cache: Optional[Sequence] = None,
                deterministic: bool = True, generator=None) -> Tuple[torch.Tensor, Optional[tuple]]:
        new_caches = [] if kv_cache is not None else None
        for i, layer in enumerate(self):
            use_rope = i < self.num_rotary_layers or self.num_rotary_layers == -1
            out = layer(x, pad_mask, rope_q if use_rope else None, rope_k if use_rope else None,
                        None if kv_cache is None else kv_cache[i], deterministic, generator)
            x = probe(f"{self.probe_name}.layer_{i}", out.last_hidden_state)
            if new_caches is not None:
                new_caches.append(out.kv_cache)
        return x, None if new_caches is None else tuple(new_caches)


class PerceiverEncoder(nn.Module):
    """Perceiver IO encoder: a learned latent array cross-attends to the
    adapted input, then self-attention blocks; repeated cross-attention with
    weight sharing: ``cross_attn_n``/``self_attn_n`` exist only when the
    repeats do not share the first layer's (block's) weights, else the
    first one is applied again.

    ``forward(x, pad_mask=None, deterministic=True, generator=None)``; a
    training forward (``deterministic=False``) draws its dropout masks from
    ``generator``. ``dropout`` drops attention probabilities,
    ``residual_dropout`` residual branches; ``activation_checkpointing`` and
    ``activation_offloading`` apply to every attention layer
    (``core.remat``)."""

    def __init__(self, input_adapter: nn.Module, num_latents: int, num_latent_channels: int,
                 num_cross_attention_heads: int = 4, num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None, num_cross_attention_layers: int = 1,
                 first_cross_attention_layer_shared: bool = False, cross_attention_widening_factor: int = 1,
                 num_self_attention_heads: int = 4, num_self_attention_qk_channels: Optional[int] = None,
                 num_self_attention_v_channels: Optional[int] = None, num_self_attention_layers_per_block: int = 6,
                 num_self_attention_blocks: int = 1, first_self_attention_block_shared: bool = True,
                 self_attention_widening_factor: int = 1, dropout: float = 0.0, residual_dropout: float = 0.0,
                 init_scale: float = 0.02, activation_checkpointing: bool = False,
                 activation_offloading: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        if num_self_attention_blocks <= 0:
            raise ValueError("num_self_attention_blocks must be > 0")
        if num_cross_attention_layers > num_self_attention_blocks:
            raise ValueError("num_cross_attention_layers must be <= num_self_attention_blocks")
        self.num_cross_attention_heads = num_cross_attention_heads
        self.num_cross_attention_layers = num_cross_attention_layers
        self.num_self_attention_blocks = num_self_attention_blocks
        self.dropout = dropout
        self.init_scale = init_scale
        self.remat_mode = remat_mode(activation_checkpointing, activation_offloading)
        self.offload_arena = OffloadArena()
        self.input_adapter = input_adapter
        self.latent_provider = TrainableQueryProvider(num_latents, num_latent_channels, dtype)

        def cross_attn():
            return CrossAttentionLayer(
                num_cross_attention_heads, num_latent_channels, input_adapter.num_input_channels,
                widening_factor=cross_attention_widening_factor, num_qk_channels=num_cross_attention_qk_channels,
                num_v_channels=num_cross_attention_v_channels, dtype=dtype, dropout=dropout,
                residual_dropout=residual_dropout,
            )

        def self_attn():
            return SelfAttentionBlock(
                num_self_attention_layers_per_block, num_self_attention_heads, num_latent_channels,
                num_rotary_layers=0, widening_factor=self_attention_widening_factor,
                num_qk_channels=num_self_attention_qk_channels, num_v_channels=num_self_attention_v_channels,
                dtype=dtype, dropout=dropout, residual_dropout=residual_dropout,
            )

        self.cross_attn_1 = cross_attn()
        self.self_attn_1 = self_attn()
        if num_cross_attention_layers > 1 and not first_cross_attention_layer_shared:
            self.cross_attn_n = cross_attn()
        if num_self_attention_blocks > 1 and not first_self_attention_block_shared:
            self.self_attn_n = self_attn()
        for child in self.children():
            if isinstance(child, (CrossAttentionLayer, SelfAttentionBlock)):
                child.set_remat(self.remat_mode, self.offload_arena)

    def _use_split_input(self, pad_mask, deterministic) -> bool:
        """The fused split-kv route's gate (JAX's ``_use_split_input``): an
        adapter that splits, no pad mask, one cross-attention head, no active
        dropout, no checkpointing or offloading. The head dims are checked
        where the input is known."""
        if not getattr(self.input_adapter, "supports_split", False):
            return False
        if pad_mask is not None or self.num_cross_attention_heads != 1:
            return False
        if self.dropout > 0.0 and not deterministic:
            return False
        return self.remat_mode is None

    def forward(self, x, pad_mask=None, return_adapted_input: bool = False, deterministic: bool = True,
                generator=None):
        """The latents (B, N, C); with ``return_adapted_input`` the pair
        ``(latents, adapted input)``, which forgoes the split-kv route (the
        joined input is made for the return value anyway), as in JAX."""
        self.offload_arena.reset()
        b = x.shape[0]
        x_latent = self.latent_provider().expand(b, -1, -1)
        use_split = not return_adapted_input and self._use_split_input(pad_mask, deterministic)
        if use_split:
            x_pix, enc = self.input_adapter.split(x)
            mha = self.cross_attn_1.cross_attn.attention
            use_split = flash_supported(split_padded(mha.qk_channels), split_padded(mha.v_channels))
        x_adapted = None
        if use_split:
            def call_ca(layer, x_latent):
                return layer.call_with_split_kv(x_latent, x_pix, enc, deterministic, generator).last_hidden_state
        else:
            x_adapted = self.input_adapter(x)

            def call_ca(layer, x_latent):
                return layer(x_latent, x_adapted, pad_mask=pad_mask, deterministic=deterministic,
                             generator=generator).last_hidden_state

        def call_sa(block, x_latent):
            return block(x_latent, deterministic=deterministic, generator=generator)[0]

        x_latent = call_ca(self.cross_attn_1, x_latent)
        x_latent = call_sa(self.self_attn_1, x_latent)
        cross_attn_n = getattr(self, "cross_attn_n", self.cross_attn_1)
        self_attn_n = getattr(self, "self_attn_n", self.self_attn_1)
        for i in range(1, self.num_self_attention_blocks):
            if i < self.num_cross_attention_layers:
                x_latent = call_ca(cross_attn_n, x_latent)
            x_latent = call_sa(self_attn_n, x_latent)
        return (x_latent, x_adapted) if return_adapted_input else x_latent


class PerceiverDecoder(nn.Module):
    """Perceiver IO decoder: output queries cross-attend to the latents, and
    the output adapter maps the result to the task output. ``dropout`` drops
    the cross-attention's probabilities in a training forward; checkpointing
    and offloading apply to the cross-attention layer."""

    def __init__(self, output_adapter: nn.Module, output_query_provider: TrainableQueryProvider,
                 num_latent_channels: int, num_cross_attention_heads: int = 4,
                 num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None, cross_attention_widening_factor: int = 1,
                 cross_attention_residual: bool = True, dropout: float = 0.0, init_scale: float = 0.02,
                 activation_checkpointing: bool = False, activation_offloading: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_scale = init_scale
        self.offload_arena = OffloadArena()
        self.output_query_provider = output_query_provider
        self.output_adapter = output_adapter
        self.cross_attn = CrossAttentionLayer(
            num_cross_attention_heads, output_query_provider.num_query_channels, num_latent_channels,
            widening_factor=cross_attention_widening_factor, num_qk_channels=num_cross_attention_qk_channels,
            num_v_channels=num_cross_attention_v_channels, attention_residual=cross_attention_residual,
            dtype=dtype, dropout=dropout,
        )
        self.cross_attn.set_remat(remat_mode(activation_checkpointing, activation_offloading), self.offload_arena)

    def forward(self, x_latent, x_adapted=None, deterministic: bool = True, generator=None,
                **adapter_kwargs) -> torch.Tensor:
        """The output queries come from ``output_query_provider(x_adapted)``
        (a trainable array ignores it; optical flow's queries are the adapted
        input); ``adapter_kwargs`` go to the output adapter (the masked LM's
        ``attend``)."""
        self.offload_arena.reset()
        query = self.output_query_provider(x_adapted)
        if query.shape[0] != x_latent.shape[0]:
            query = query.expand(x_latent.shape[0], -1, -1)
        out = self.cross_attn(query, x_latent, deterministic=deterministic, generator=generator)
        return self.output_adapter(out.last_hidden_state, **adapter_kwargs)


@torch.no_grad()
def init_normal_(parts: Sequence[Tuple[nn.Module, float]], generator: torch.Generator) -> None:
    """The random initialization of a Perceiver IO model, part by part (the
    encoder with its input adapter, then the decoder): normal(0, the part's
    ``init_scale``) projections, embeddings and query arrays drawn from
    ``generator`` on the CPU in module order, zero biases, unit LayerNorms
    (as constructed)."""
    for part, scale in parts:
        for module in part.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * scale)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, TrainableQueryProvider):
                module._query.copy_(torch.randn(module._query.shape, generator=generator) * scale)


class PerceiverIO(nn.Sequential):
    """Encoder + decoder (the reference's ``nn.Sequential``: parameters
    under ``0.`` and ``1.``)."""

    def __init__(self, encoder: PerceiverEncoder, decoder: PerceiverDecoder):
        super().__init__(encoder, decoder)

    @property
    def encoder(self) -> PerceiverEncoder:
        return self[0]

    @property
    def decoder(self) -> PerceiverDecoder:
        return self[1]

    def forward(self, x, pad_mask=None, deterministic: bool = True, generator=None) -> torch.Tensor:
        x_latent = self.encoder(x, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        return self.decoder(x_latent, deterministic=deterministic, generator=generator)


class PerceiverAR(nn.Module):
    """Perceiver AR (arXiv:2202.07765): one causal cross-attention of the
    latent suffix over ``[prefix; latents]``, then a causal self-attention
    stack over the latents, with right-aligned RoPE.

    Call modes: ``kv_cache=None`` plain forward; ``kv_cache=...`` with
    ``decode=False`` the prompt pass that fills the (empty) caches;
    ``decode=True`` one incremental step whose whole input is latent, with
    positions continuing from the cache fill level."""

    def __init__(self, input_adapter: TokenInputAdapterWithRotarySupport, num_heads: int = 8,
                 num_self_attention_layers: int = 6, num_self_attention_rotary_layers: int = 1,
                 self_attention_widening_factor: int = 4, cross_attention_widening_factor: int = 4,
                 cross_attention_dropout: float = 0.5, prefix_dropout_mode: str = "gather",
                 post_attention_dropout: float = 0.0, residual_dropout: float = 0.0,
                 activation_checkpointing: bool = False, activation_offloading: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if prefix_dropout_mode not in ("gather", "gather_embed", "mask"):
            raise ValueError(f"unknown prefix_dropout_mode: {prefix_dropout_mode!r}")
        c = input_adapter.num_input_channels
        self.cross_attention_dropout = cross_attention_dropout
        self.prefix_dropout_mode = prefix_dropout_mode
        self.input_adapter = input_adapter
        self.dtype = dtype
        # post-attention dropout is the layers' dropout on attention probabilities
        self.cross_attention = CrossAttentionLayer(
            num_heads, c, c, causal_attention=True, widening_factor=cross_attention_widening_factor,
            qkv_bias=False, out_bias=True, mlp_bias=False, dtype=dtype, dropout=post_attention_dropout,
            residual_dropout=residual_dropout,
        )
        self.self_attention = SelfAttentionBlock(
            num_self_attention_layers, num_heads, c, num_rotary_layers=num_self_attention_rotary_layers,
            causal_attention=True, widening_factor=self_attention_widening_factor,
            qkv_bias=False, out_bias=False, mlp_bias=False, dtype=dtype, dropout=post_attention_dropout,
            residual_dropout=residual_dropout,
        )
        self.self_attention.probe_name = "self_attention"
        self.offload_arena = OffloadArena()
        mode = remat_mode(activation_checkpointing, activation_offloading)
        self.cross_attention.set_remat(mode, self.offload_arena)
        self.self_attention.set_remat(mode, self.offload_arena)

    def perceiver_ar(self, x, prefix_len: int, pad_mask=None, kv_cache=None, decode: bool = False,
                     sa_pad_mask=None, pos_shift=None, deterministic: bool = True, prefix_keep_idx=None,
                     generator: Optional[torch.Generator] = None,
                     pos_offset: Optional[int] = None) -> Tuple[torch.Tensor, Optional[tuple]]:
        """``deterministic=False`` is the training forward: prefix dropout
        keeps ``prefix_len - int(prefix_len * cross_attention_dropout)``
        prefix positions, the set ``prefix_keep_idx`` (B, keep), sorted
        unique per row, or, without one, the top-k of uniforms drawn on the
        input's device from ``generator`` (the default generator when None;
        in ``"mask"`` mode the uniforms at or above the keep-th largest, the
        same set). The layers then draw their dropout masks from
        ``generator`` in call order.

        ``pos_offset``: the absolute position of the input's first token,
        for the shared-prefix prefill (``generation.make_shared_prefill_fn``):
        the prompt's leading ``pos_offset`` tokens already lie in the
        cross-attention cache, and the forward runs over the suffix alone,
        whose token ``i`` sits at ``pos_offset + i``. Keys rotate at write
        and the causal mask is right-aligned, so the result is the
        full-prompt forward's. Forwards only: a decode step takes its
        positions from the cache, and prefix dropout would draw its keep set
        over positions from 0."""
        if kv_cache is not None and not deterministic and self.cross_attention_dropout > 0.0:
            raise ValueError("cross-attention dropout not supported with caching")
        if decode:
            if kv_cache is None:
                raise ValueError("decode=True requires kv_cache")
            if pos_offset is not None:
                raise ValueError("pos_offset applies to the forward route; decode steps derive positions "
                                 "from the cache fill level")
            if prefix_keep_idx is not None:
                raise ValueError("prefix_keep_idx applies to training forwards, not decode steps")
            return self._decode_step(x, pad_mask, kv_cache, sa_pad_mask, pos_shift)
        return self._forward(x, prefix_len, pad_mask, kv_cache, deterministic, prefix_keep_idx, generator,
                             pos_offset)

    def _forward(self, x, prefix_len, pad_mask, kv_cache, deterministic=True, prefix_keep_idx=None,
                 generator=None, pos_offset=None):
        b, n = x.shape[0], x.shape[1]
        if not 0 <= prefix_len < n:
            raise ValueError(f"prefix_len ({prefix_len}) out of valid range [0..{n})")
        self.offload_arena.reset()
        dropout_active = not deterministic and prefix_len > 0 and self.cross_attention_dropout > 0.0
        if pos_offset is not None and dropout_active:
            raise ValueError("pos_offset is a serving-forward seam; cross-attention dropout is not supported "
                             "with it")
        mode = self.prefix_dropout_mode
        keep_idx = drop = None
        if dropout_active:
            keep = prefix_len - int(prefix_len * self.cross_attention_dropout)
            if prefix_keep_idx is None:
                rand = torch.rand((b, prefix_len), device=x.device, generator=generator)
                if mode == "mask":
                    # threshold at the keep-th largest uniform: top-k's set
                    drop = rand < torch.topk(rand, keep, dim=1).values[:, -1:]
                else:
                    keep_idx = torch.sort(torch.topk(rand, keep, dim=1).indices, dim=1).values
            else:
                keep_idx = torch.as_tensor(prefix_keep_idx, device=x.device).long()
                if keep_idx.shape[-1] != keep:
                    raise ValueError(f"prefix_keep_idx carries {keep_idx.shape[-1]} indices; "
                                     f"this config keeps {keep} of {prefix_len} prefix positions")
                if mode == "mask":
                    drop = torch.ones((b, prefix_len), dtype=torch.bool, device=x.device).scatter_(1, keep_idx, False)
                    keep_idx = None
            if pad_mask is None and mode == "gather":
                # compact route: select token ids and position rows before
                # embedding, so the full-length embedding never exists
                x_emb, frq = self.input_adapter.embed_compact(x, keep_idx, prefix_len)
                x_emb = probe("perceiver_ar.embed", x_emb)
                return self._attend(x_emb[:, keep:], x_emb[:, :keep], frq[:, keep:], frq[:, :keep],
                                    None, None, kv_cache, deterministic, generator)
        if pad_mask is None:
            pos = None if pos_offset is None else positions(b, n, offset=pos_offset, device=x.device)
            x_emb, frq = self.input_adapter(x, pos)
            pad_latent = pad_prefix = None
        else:
            shift = pad_mask.sum(dim=1, keepdim=True)
            x_emb, frq = self.input_adapter(x, positions(b, n, shift=shift, offset=pos_offset))
            pad_latent, pad_prefix = pad_mask[:, prefix_len:], pad_mask[:, :prefix_len]
        x_emb = probe("perceiver_ar.embed", x_emb)
        x_prefix, frq_prefix = x_emb[:, :prefix_len], frq[:, :prefix_len]
        if keep_idx is not None:
            # the embedded-row gather (a left-padded batch, or "gather_embed"):
            # rows, their rotary encodings and their pad flags
            x_prefix = torch.gather(x_prefix, 1, keep_idx[..., None].expand(-1, -1, x_prefix.shape[2]))
            frq_prefix = torch.gather(frq_prefix, 1, keep_idx[..., None].expand(-1, -1, frq_prefix.shape[2]))
            if pad_prefix is not None:
                pad_prefix = torch.gather(pad_prefix, 1, keep_idx)
        if drop is not None:
            # "mask": the full prefix, its dropped rows masked out of the
            # cross-attention's softmax (the gathered softmax, numerically)
            pad_prefix = drop if pad_prefix is None else pad_prefix | drop
            if pad_latent is None:
                pad_latent = torch.zeros((b, n - prefix_len), dtype=torch.bool, device=x.device)
        return self._attend(x_emb[:, prefix_len:], x_prefix, frq[:, prefix_len:], frq_prefix,
                            pad_latent, pad_prefix, kv_cache, deterministic, generator)

    def _attend(self, x_latent, x_prefix, frq_latent, frq_prefix, pad_latent, pad_prefix, kv_cache,
                deterministic=True, generator=None):
        # the cross-attention's rotary rows and pad flags go as (prefix,
        # latent) pairs: the two-segment route never joins them
        rope_k_ca = (frq_prefix, frq_latent)
        pad_ca = None if pad_prefix is None else (pad_prefix, pad_latent)
        if kv_cache is None:
            ca_cache, sa_cache = None, None
        else:
            ca_cache, sa_cache = kv_cache[0], tuple(kv_cache[1:])
            if pad_ca is not None:
                # the pad mask reads against cache slots: align it to capacity
                pad_ca = _joined_rows(pad_ca)
                pad_ca = torch.nn.functional.pad(pad_ca, (0, ca_cache.capacity - pad_ca.shape[1]))
        ca_out = self.cross_attention(x_latent, None, x_prefix, pad_ca, frq_latent, rope_k_ca, ca_cache,
                                      deterministic, generator)
        h, sa_caches = self.self_attention(probe("perceiver_ar.cross_attend", ca_out.last_hidden_state), None,
                                           frq_latent, frq_latent, sa_cache, deterministic, generator)
        new_cache = None if kv_cache is None else (ca_out.kv_cache,) + sa_caches
        return h, new_cache

    def seq_parallel_forward(self, x_latent, frq_latent, x_prefix_local, frq_prefix_local, *, group,
                             prefix_pad_local=None, deterministic: bool = True, generator=None) -> torch.Tensor:
        """Sequence-parallel forward with the prefix sharded over ``group``
        (the mesh's ``seq`` group; the JAX method runs inside ``shard_map``).
        Inputs are embedded (see :meth:`CausalSequenceModel.seq_parallel_forward`
        for the token-level entry): ``x_latent``/``frq_latent`` replicated,
        ``x_prefix_local``/``frq_prefix_local`` this rank's prefix block,
        ``prefix_pad_local`` (B, P_local) True at padding. The causal
        cross-attention over ``[prefix; latents]`` splits exactly into a
        per-rank prefix partial, LSE-combined across the group, and the
        replicated causal latent partial (``CrossAttentionLayer.seq_parallel``);
        the latent self-attention stack runs replicated, through the usual
        route (K2, K4a, K4b, K1, K5 on the card). Returns the latent hidden
        state (B, L, C), the same on every rank.

        Training (``deterministic=False``) keeps the prefix cross-attention
        dropout as a keep mask: every rank draws the dense ``"mask"`` mode's
        set from ``generator`` (seeded alike on every rank; required) over
        the GLOBAL prefix, the top-k of ``torch.rand``, and masks its own
        block.
        Post-attention and residual dropout raise, as in JAX."""
        ca_layer = self.cross_attention
        if not deterministic and (ca_layer.cross_attn.attention.dropout > 0.0 or ca_layer.residual_dropout > 0.0):
            raise ValueError("post-attention/residual dropout is not supported on the sequence-parallel path; "
                             "set post_attention_dropout/residual_dropout to 0 or pass deterministic=True")
        import torch.distributed as dist

        self.offload_arena.reset()
        b, p_local = x_prefix_local.shape[0], x_prefix_local.shape[1]
        mask_p = torch.zeros((b, p_local), dtype=torch.bool, device=x_latent.device)
        if prefix_pad_local is not None:
            mask_p = mask_p | prefix_pad_local.bool()
        if not deterministic and self.cross_attention_dropout > 0.0 and p_local > 0:
            if generator is None:
                # the default generator is seeded per process: the ranks would
                # mask different keep sets of one prefix
                raise ValueError("the sequence-parallel training forward draws its prefix keep set from "
                                 "`generator`, seeded alike on every rank; pass one")
            p_total = p_local * dist.get_world_size(group)
            keep = p_total - int(p_total * self.cross_attention_dropout)
            rand = torch.rand((b, p_total), device=x_latent.device, generator=generator)
            drop = rand < torch.topk(rand, keep, dim=1).values[:, -1:]
            start = dist.get_rank(group) * p_local
            mask_p = mask_p | drop[:, start:start + p_local]
        h = ca_layer.seq_parallel(x_latent, x_prefix_local, frq_latent, frq_prefix_local, mask_p, group)
        h, _ = self.self_attention(probe("perceiver_ar.cross_attend", h), None, frq_latent, frq_latent, None,
                                   deterministic, generator)
        return h

    def _decode_step(self, x, pad_mask, kv_cache, sa_pad_mask, pos_shift):
        b, n_x = x.shape[0], x.shape[1]
        ca_cache, sa_cache = kv_cache[0], tuple(kv_cache[1:])
        if pos_shift is not None:
            shift = pos_shift
        else:
            shift = None if pad_mask is None else pad_mask.sum(dim=1, keepdim=True)
        offset = ca_cache.length
        if torch.is_tensor(offset):
            # a device length: per slot (paged, (S,)) or for the batch
            # (contiguous, 0-d); each row continues from its fill level
            offset = offset.long().reshape(-1, 1)
        q_pos = positions(b, n_x, shift=shift, offset=offset, device=x.device)
        x_emb, frq_q = self.input_adapter(x, q_pos)
        x_prefix = x_emb.new_zeros((b, 0, x_emb.shape[-1]))
        ca_out = self.cross_attention(x_emb, None, x_prefix, pad_mask, frq_q, frq_q, ca_cache)
        h, sa_caches = self.self_attention(probe("perceiver_ar.cross_attend", ca_out.last_hidden_state), sa_pad_mask,
                                           frq_q, frq_q, sa_cache)
        return h, (ca_out.kv_cache,) + sa_caches


class CausalSequenceModel(PerceiverAR):
    """Perceiver AR + token input adapter + optional final LayerNorm +
    tied-embedding logits.

    :param device: where the parameters live — ``"cuda"`` by default; asking
        for CUDA without a card raises (pass ``device="cpu"``); ``"meta"``
        builds the modules without data (a parameter count).
    :param generator: CPU ``torch.Generator`` for the random initialization
        (normal(0, ``init_scale``) projections and embeddings, zero biases,
        unit LayerNorms); a generator seeded 0 when None, so construction is
        deterministic. Weights are drawn on the CPU and then moved, so one
        seed gives the same model on every device.
    :param dtype: the compute dtype (``torch.bfloat16`` is the JAX package's
        ``dtype=jnp.bfloat16``; see the module docstring); the parameters are
        f32 either way.
    """

    def __init__(self, config: CausalSequenceModelConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        dev = resolve_device(device, allow_meta=True)
        meta = dev.type == "meta"
        rotated = config.num_channels // config.num_heads
        if config.abs_pos_emb:
            rotated //= 2  # rotary embedding on the first half of each head's channels
        with torch.device("meta") if meta else contextlib.nullcontext():
            adapter = TokenInputAdapterWithRotarySupport(
                config.vocab_size, config.max_seq_len, config.num_channels,
                abs_pos_emb=config.abs_pos_emb, rotated_channels_per_head=rotated, dtype=dtype,
            )
            super().__init__(
                adapter, num_heads=config.num_heads,
                num_self_attention_layers=config.num_self_attention_layers,
                num_self_attention_rotary_layers=config.num_self_attention_rotary_layers,
                self_attention_widening_factor=config.self_attention_widening_factor,
                cross_attention_widening_factor=config.cross_attention_widening_factor,
                cross_attention_dropout=config.cross_attention_dropout,
                prefix_dropout_mode=config.prefix_dropout_mode,
                post_attention_dropout=config.post_attention_dropout,
                residual_dropout=config.residual_dropout,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype,
            )
            self.config = config
            if config.output_norm:
                self.out_norm = FusedLayerNorm(config.num_channels, LAYER_NORM_EPSILON)
            self.output_adapter = TiedTokenOutputAdapter(config.vocab_size, emb_bias=config.output_bias)
        if not meta:
            self._init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
            self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator) -> None:
        std = self.config.init_scale
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * std)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()

    def truncated(self, config: CausalSequenceModelConfig) -> "CausalSequenceModel":
        """A model of this class over ``config`` (this model's config with
        fewer latent self-attention layers) that shares this model's modules:
        the embedding, the cross-attention layer, the first
        ``config.num_self_attention_layers`` self-attention layers, the
        out-norm and the tied readout. No parameter is copied, so a write
        into this model's weights reaches it (the speculative drafter,
        ``generation.make_drafter``)."""
        out = type(self).__new__(type(self))
        nn.Module.__init__(out)
        for name in ("input_adapter", "cross_attention", "out_norm", "output_adapter"):
            if hasattr(self, name):
                setattr(out, name, getattr(self, name))
        block = SelfAttentionBlock.__new__(SelfAttentionBlock)
        nn.Sequential.__init__(block, *list(self.self_attention)[: config.num_self_attention_layers])
        block.num_rotary_layers = config.num_self_attention_rotary_layers
        block.probe_name = self.self_attention.probe_name
        out.self_attention = block
        out.offload_arena = self.offload_arena
        out.cross_attention_dropout = self.cross_attention_dropout
        out.prefix_dropout_mode = self.prefix_dropout_mode
        out.dtype = self.dtype
        out.config = config
        out.training = self.training
        return out

    @property
    def device(self) -> torch.device:
        return self.input_adapter.txt_embedding.weight.device

    @property
    def max_seq_len(self) -> int:
        return self.config.max_seq_len

    @property
    def max_latents(self) -> int:
        return self.config.max_latents

    @property
    def max_prefix_len(self) -> int:
        return self.config.max_seq_len - self.config.max_latents

    @staticmethod
    def init_cache(config: CausalSequenceModelConfig, batch_size: int, ca_capacity: Optional[int] = None,
                   sa_capacity: Optional[int] = None, dtype=torch.float32,
                   device: DeviceLike = "cuda") -> Tuple[KVCache, ...]:
        """Empty contiguous caches on ``device`` (CUDA by default): one
        cross-attention cache over the window and one per self-attention
        layer over the latents."""
        c = config.num_channels
        ca = init_kv_cache(batch_size, ca_capacity or config.max_seq_len, c, c, dtype, device)
        sas = tuple(
            init_kv_cache(batch_size, sa_capacity or config.max_latents, c, c, dtype, device)
            for _ in range(config.num_self_attention_layers)
        )
        return (ca,) + sas

    @staticmethod
    def init_paged_cache(config: CausalSequenceModelConfig, slots: int, page_size: int, ca_num_pages: int,
                         ca_pages_per_slot: int, sa_num_pages: int, sa_pages_per_slot: int,
                         dtype=torch.float32, device: DeviceLike = "cuda") -> Tuple[PagedKVCache, ...]:
        """Empty paged caches for the batched engine: one pool for the
        cross-attention window and one per self-attention layer (the SA
        layers share one page-id space: they append in lockstep)."""
        c = config.num_channels
        ca = init_paged_kv_cache(slots, ca_num_pages, page_size, ca_pages_per_slot, c, c, dtype, device)
        sas = tuple(
            init_paged_kv_cache(slots, sa_num_pages, page_size, sa_pages_per_slot, c, c, dtype, device)
            for _ in range(config.num_self_attention_layers)
        )
        return (ca,) + sas

    def seq_parallel_forward(self, latent_ids: torch.Tensor, prefix_ids_local: torch.Tensor, *, group,
                             prefix_pad_local: Optional[torch.Tensor] = None, deterministic: bool = True,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token-level sequence-parallel forward: ``latent_ids`` (B, L)
        replicated, ``prefix_ids_local`` (B, P / n) this rank's prefix block
        over ``group`` (``parallel.long_context.make_seq_parallel_clm_forward``
        is the whole-array wrapper). Returns the replicated latent logits
        (B, L, V).

        Positions are global: rank ``i`` embeds prefix positions
        ``[i * P_local, (i + 1) * P_local)``, the latents sit at ``[P, P + L)``,
        and left padding shifts every position by the global pad count (the
        all-reduced sum of the ranks' counts), as the dense forward's
        ``positions()`` shift."""
        import torch.distributed as dist

        from perceiver_io_tpu_torch.parallel.ring_attention import psum

        b, n_lat = latent_ids.shape
        p_local = prefix_ids_local.shape[1]
        p_total = p_local * dist.get_world_size(group)
        if p_total > self.max_prefix_len:
            raise ValueError(f"prefix_len ({p_total}) exceeds max_prefix_len ({self.max_prefix_len})")
        if not 0 < n_lat <= self.max_latents:
            raise ValueError(f"number of latent positions ({n_lat}) out of valid range [1..{self.max_latents}]")
        dev = latent_ids.device
        shift = None
        if prefix_pad_local is not None:
            shift = psum(prefix_pad_local.sum(dim=1, keepdim=True), group)
        offset = dist.get_rank(group) * p_local
        emb_prefix, frq_prefix = self.input_adapter(prefix_ids_local,
                                                    positions(b, p_local, shift=shift, offset=offset, device=dev))
        emb_latent, frq_latent = self.input_adapter(latent_ids,
                                                    positions(b, n_lat, shift=shift, offset=p_total, device=dev))
        h = super().seq_parallel_forward(emb_latent, frq_latent, emb_prefix, frq_prefix, group=group,
                                         prefix_pad_local=prefix_pad_local, deterministic=deterministic,
                                         generator=generator)
        if self.config.output_norm:
            h = self.out_norm(h)
        return probe("logits", self.output_adapter(h, attend=self.input_adapter.attend))

    def forward(self, x: torch.Tensor, prefix_len: int, pad_mask: Optional[torch.Tensor] = None,
                kv_cache: Optional[tuple] = None, decode: bool = False, sa_pad_mask=None,
                pos_shift=None, deterministic: bool = True, prefix_keep_idx=None,
                generator: Optional[torch.Generator] = None, pos_offset: Optional[int] = None) -> CausalModelOutput:
        """Logits (B, N_latent, V) for token ids ``x`` (B, N); see
        :class:`PerceiverAR` for the call modes, the training arguments and
        ``pos_offset``. ``pad_mask`` (True = left padding) is (B, N) for a
        forward, slot-aligned (B, capacity) for a decode step; ``sa_pad_mask``/
        ``pos_shift`` apply to decode steps. Differentiable without a cache;
        with one, it runs under ``torch.no_grad()``."""
        if prefix_len > self.max_prefix_len:
            raise ValueError(f"prefix_len ({prefix_len}) exceeds max_prefix_len ({self.max_prefix_len})")
        with torch.set_grad_enabled(torch.is_grad_enabled() and kv_cache is None):
            h, cache = self.perceiver_ar(x, prefix_len, pad_mask, kv_cache, decode, sa_pad_mask, pos_shift,
                                         deterministic, prefix_keep_idx, generator, pos_offset)
            if self.config.output_norm:
                h = self.out_norm(h)
            logits = probe("logits", self.output_adapter(h, attend=self.input_adapter.attend))
        return CausalModelOutput(h, logits, cache)
