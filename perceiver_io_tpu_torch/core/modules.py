"""Perceiver AR and the causal sequence model in PyTorch (counterpart of
``perceiver_io_tpu/core/modules.py``: ``CrossAttention``, ``SelfAttention``,
``MLP``, the attention layers, ``SelfAttentionBlock``, ``PerceiverAR`` and
``CausalSequenceModel``).

The module tree reproduces the reference PyTorch implementation's parameter
names (``cross_attention.0.module.q_norm.weight``,
``self_attention.{i}.1.module.3.weight``, ``output_adapter.bias``, ...), so
``convert.state_dict_from_jax`` is a renaming of the JAX tree and a reference
checkpoint's ``state_dict`` loads as it is.

The cache-free forward is differentiable and takes the training arguments
(``deterministic``, ``prefix_keep_idx``): cross-attention prefix dropout in
the default ``"gather"`` mode, on the compact route for an unpadded batch and
the embedded-row gather for a left-padded one. The other training-time
options (``prefix_dropout_mode`` ``"mask"``/``"gather_embed"``, post-attention
and residual dropout, activation checkpointing or offloading) are not ported:
a training forward that asks for one raises ``NotImplementedError``. Calls
with a KV cache (prefill and decode) are inference only and run under
``torch.no_grad()``.

Under ``fast_kernels({"twoseg"})`` (``ops.flash_attention``; off by default,
as in the JAX package) every cache-free causal cross-attention with a
non-empty prefix takes the two-segment route, training and eval forwards
alike: the kept prefix and the latents go to the kernels as separate K/V
operands, and neither ``[kv_norm(prefix); q_norm(latents)]`` nor its
projections, rotary rows or pad flags are ever joined. Calls with a KV cache,
and an empty prefix, keep the concat route.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.core.adapter import TiedTokenOutputAdapter, TokenInputAdapterWithRotarySupport
from perceiver_io_tpu_torch.core.attention import AttentionOutput, MultiHeadAttention
from perceiver_io_tpu_torch.core.cache import KVCache, PagedKVCache, init_kv_cache, init_paged_kv_cache
from perceiver_io_tpu_torch.core.config import CausalSequenceModelConfig
from perceiver_io_tpu_torch.core.position import positions
from perceiver_io_tpu_torch.device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.ops.flash_attention import fast_features
from perceiver_io_tpu_torch.ops.layernorm import FusedLayerNorm

LAYER_NORM_EPSILON = 1e-5


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
                 causal_attention: bool = False, qkv_bias: bool = True, out_bias: bool = True):
        super().__init__()
        self.q_norm = FusedLayerNorm(num_q_input_channels, LAYER_NORM_EPSILON)
        self.kv_norm = FusedLayerNorm(num_kv_input_channels, LAYER_NORM_EPSILON)
        self.attention = MultiHeadAttention(
            num_heads, num_q_input_channels, num_kv_input_channels,
            causal_attention=causal_attention, qkv_bias=qkv_bias, out_bias=out_bias,
        )

    def _two_segment_ok(self, x_q, x_kv_prefix, kv_cache) -> bool:
        """The gate of the two-segment route (JAX's
        ``CrossAttention._two_segment_ok``): "twoseg" is on, no KV cache, a
        causal layer, a non-empty prefix, and head dims the packed kernels
        take (on a CUDA tensor, dims they cannot take raise). When False the
        concat route runs unchanged."""
        return ("twoseg" in fast_features() and kv_cache is None and self.attention.causal_attention
                and x_kv_prefix.shape[1] >= 1 and self.attention.packed_route_ok(x_q))

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache=None) -> AttentionOutput:
        x_q = self.q_norm(x_q)
        if x_kv is None:
            if self._two_segment_ok(x_q, x_kv_prefix, kv_cache):
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
        return self.attention(x_q, x_kv, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache)


class SelfAttention(nn.Module):
    """Pre-layer-norm self-attention."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False,
                 qkv_bias: bool = True, out_bias: bool = True):
        super().__init__()
        self.norm = FusedLayerNorm(num_channels, LAYER_NORM_EPSILON)
        self.attention = MultiHeadAttention(
            num_heads, num_channels, num_channels,
            causal_attention=causal_attention, qkv_bias=qkv_bias, out_bias=out_bias,
        )

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None, kv_cache=None) -> AttentionOutput:
        x = self.norm(x)
        return self.attention(x, x, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k, kv_cache=kv_cache)


class MLP(nn.Sequential):
    """LayerNorm -> Linear(widening * C) -> GELU (exact) -> Linear(C)."""

    def __init__(self, num_channels: int, widening_factor: int, bias: bool = True):
        super().__init__(
            FusedLayerNorm(num_channels, LAYER_NORM_EPSILON),
            nn.Linear(num_channels, widening_factor * num_channels, bias=bias),
            nn.GELU(),
            nn.Linear(widening_factor * num_channels, num_channels, bias=bias),
        )


class CrossAttentionLayer(nn.Sequential):
    """Cross-attention + MLP, each with a residual."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 causal_attention: bool = False, widening_factor: int = 1, qkv_bias: bool = True,
                 out_bias: bool = True, mlp_bias: bool = True):
        super().__init__(
            Residual(CrossAttention(num_heads, num_q_input_channels, num_kv_input_channels,
                                    causal_attention, qkv_bias, out_bias)),
            Residual(MLP(num_q_input_channels, widening_factor, mlp_bias)),
        )

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache=None) -> AttentionOutput:
        attn = self[0].module(x_q, x_kv, x_kv_prefix, pad_mask, rope_q, rope_k, kv_cache)
        h = x_q + attn.last_hidden_state
        h = h + self[1].module(h)
        return AttentionOutput(h, attn.kv_cache)


class SelfAttentionLayer(nn.Sequential):
    """Self-attention + MLP, each with a residual."""

    def __init__(self, num_heads: int, num_channels: int, causal_attention: bool = False,
                 widening_factor: int = 1, qkv_bias: bool = True, out_bias: bool = True,
                 mlp_bias: bool = True):
        super().__init__(
            Residual(SelfAttention(num_heads, num_channels, causal_attention, qkv_bias, out_bias)),
            Residual(MLP(num_channels, widening_factor, mlp_bias)),
        )

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None, kv_cache=None) -> AttentionOutput:
        attn = self[0].module(x, pad_mask, rope_q, rope_k, kv_cache)
        h = x + attn.last_hidden_state
        h = h + self[1].module(h)
        return AttentionOutput(h, attn.kv_cache)


class SelfAttentionBlock(nn.Sequential):
    """Stack of self-attention layers with per-layer KV caches; layer ``i``
    gets RoPE iff ``i < num_rotary_layers`` (-1 = every layer)."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int, num_rotary_layers: int = 1,
                 causal_attention: bool = False, widening_factor: int = 1, qkv_bias: bool = True,
                 out_bias: bool = True, mlp_bias: bool = True):
        super().__init__(*[
            SelfAttentionLayer(num_heads, num_channels, causal_attention, widening_factor,
                               qkv_bias, out_bias, mlp_bias)
            for _ in range(num_layers)
        ])
        self.num_rotary_layers = num_rotary_layers

    def forward(self, x, pad_mask=None, rope_q=None, rope_k=None,
                kv_cache: Optional[Sequence] = None) -> Tuple[torch.Tensor, Optional[tuple]]:
        new_caches = [] if kv_cache is not None else None
        for i, layer in enumerate(self):
            use_rope = i < self.num_rotary_layers or self.num_rotary_layers == -1
            out = layer(x, pad_mask, rope_q if use_rope else None, rope_k if use_rope else None,
                        None if kv_cache is None else kv_cache[i])
            x = out.last_hidden_state
            if new_caches is not None:
                new_caches.append(out.kv_cache)
        return x, None if new_caches is None else tuple(new_caches)


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
                 activation_checkpointing: bool = False, activation_offloading: bool = False):
        super().__init__()
        if prefix_dropout_mode not in ("gather", "gather_embed", "mask"):
            raise ValueError(f"unknown prefix_dropout_mode: {prefix_dropout_mode!r}")
        c = input_adapter.num_input_channels
        self.cross_attention_dropout = cross_attention_dropout
        self.prefix_dropout_mode = prefix_dropout_mode
        # training options with no port yet: a training forward refuses them
        self._unported = {
            "post_attention_dropout": post_attention_dropout > 0.0,
            "residual_dropout": residual_dropout > 0.0,
            "activation_checkpointing": activation_checkpointing,
            "activation_offloading": activation_offloading,
        }
        self.input_adapter = input_adapter
        self.cross_attention = CrossAttentionLayer(
            num_heads, c, c, causal_attention=True, widening_factor=cross_attention_widening_factor,
            qkv_bias=False, out_bias=True, mlp_bias=False,
        )
        self.self_attention = SelfAttentionBlock(
            num_self_attention_layers, num_heads, c, num_rotary_layers=num_self_attention_rotary_layers,
            causal_attention=True, widening_factor=self_attention_widening_factor,
            qkv_bias=False, out_bias=False, mlp_bias=False,
        )

    def perceiver_ar(self, x, prefix_len: int, pad_mask=None, kv_cache=None, decode: bool = False,
                     sa_pad_mask=None, pos_shift=None, deterministic: bool = True, prefix_keep_idx=None,
                     generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[tuple]]:
        """``deterministic=False`` is the training forward: prefix dropout
        keeps ``prefix_len - int(prefix_len * cross_attention_dropout)``
        prefix positions, the set ``prefix_keep_idx`` (B, keep), sorted
        unique per row, or, without one, the top-k of uniforms drawn on the
        input's device from ``generator`` (the default generator when None)."""
        if kv_cache is not None and not deterministic and self.cross_attention_dropout > 0.0:
            raise ValueError("cross-attention dropout not supported with caching")
        if decode:
            if kv_cache is None:
                raise ValueError("decode=True requires kv_cache")
            if prefix_keep_idx is not None:
                raise ValueError("prefix_keep_idx applies to training forwards, not decode steps")
            return self._decode_step(x, pad_mask, kv_cache, sa_pad_mask, pos_shift)
        return self._forward(x, prefix_len, pad_mask, kv_cache, deterministic, prefix_keep_idx, generator)

    def _forward(self, x, prefix_len, pad_mask, kv_cache, deterministic=True, prefix_keep_idx=None,
                 generator=None):
        b, n = x.shape[0], x.shape[1]
        if not 0 <= prefix_len < n:
            raise ValueError(f"prefix_len ({prefix_len}) out of valid range [0..{n})")
        dropout_active = not deterministic and prefix_len > 0 and self.cross_attention_dropout > 0.0
        if not deterministic:
            asked = [name for name, on in self._unported.items() if on]
            if dropout_active and self.prefix_dropout_mode != "gather":
                asked.append(f"prefix_dropout_mode={self.prefix_dropout_mode!r}")
            if asked:
                raise NotImplementedError(f"not ported for training forwards: {', '.join(asked)}")
        keep_idx = None
        if dropout_active:
            keep = prefix_len - int(prefix_len * self.cross_attention_dropout)
            if prefix_keep_idx is None:
                rand = torch.rand((b, prefix_len), device=x.device, generator=generator)
                keep_idx = torch.sort(torch.topk(rand, keep, dim=1).indices, dim=1).values
            else:
                keep_idx = torch.as_tensor(prefix_keep_idx, device=x.device).long()
                if keep_idx.shape[-1] != keep:
                    raise ValueError(f"prefix_keep_idx carries {keep_idx.shape[-1]} indices; "
                                     f"this config keeps {keep} of {prefix_len} prefix positions")
            if pad_mask is None:
                # compact route: select token ids and position rows before
                # embedding, so the full-length embedding never exists
                x_emb, frq = self.input_adapter.embed_compact(x, keep_idx, prefix_len)
                return self._attend(x_emb[:, keep:], x_emb[:, :keep], frq[:, keep:], frq[:, :keep],
                                    None, None, kv_cache)
        if pad_mask is None:
            x_emb, frq = self.input_adapter(x, None)
            pad_latent = pad_prefix = None
        else:
            shift = pad_mask.sum(dim=1, keepdim=True)
            x_emb, frq = self.input_adapter(x, positions(b, n, shift=shift))
            pad_latent, pad_prefix = pad_mask[:, prefix_len:], pad_mask[:, :prefix_len]
        x_prefix, frq_prefix = x_emb[:, :prefix_len], frq[:, :prefix_len]
        if keep_idx is not None:
            # the embedded-row gather (left-padded batch): rows, their rotary
            # encodings and their pad flags
            x_prefix = torch.gather(x_prefix, 1, keep_idx[..., None].expand(-1, -1, x_prefix.shape[2]))
            frq_prefix = torch.gather(frq_prefix, 1, keep_idx[..., None].expand(-1, -1, frq_prefix.shape[2]))
            pad_prefix = torch.gather(pad_prefix, 1, keep_idx)
        return self._attend(x_emb[:, prefix_len:], x_prefix, frq[:, prefix_len:], frq_prefix,
                            pad_latent, pad_prefix, kv_cache)

    def _attend(self, x_latent, x_prefix, frq_latent, frq_prefix, pad_latent, pad_prefix, kv_cache):
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
        ca_out = self.cross_attention(x_latent, None, x_prefix, pad_ca, frq_latent, rope_k_ca, ca_cache)
        h, sa_caches = self.self_attention(ca_out.last_hidden_state, None, frq_latent, frq_latent, sa_cache)
        new_cache = None if kv_cache is None else (ca_out.kv_cache,) + sa_caches
        return h, new_cache

    def _decode_step(self, x, pad_mask, kv_cache, sa_pad_mask, pos_shift):
        b, n_x = x.shape[0], x.shape[1]
        ca_cache, sa_cache = kv_cache[0], tuple(kv_cache[1:])
        if pos_shift is not None:
            shift = pos_shift
        else:
            shift = None if pad_mask is None else pad_mask.sum(dim=1, keepdim=True)
        offset = ca_cache.length
        if torch.is_tensor(offset):
            # paged cache: each slot continues from its own fill level
            offset = offset.long()[:, None]
        q_pos = positions(b, n_x, shift=shift, offset=offset, device=x.device)
        x_emb, frq_q = self.input_adapter(x, q_pos)
        x_prefix = x_emb.new_zeros((b, 0, x_emb.shape[-1]))
        ca_out = self.cross_attention(x_emb, None, x_prefix, pad_mask, frq_q, frq_q, ca_cache)
        h, sa_caches = self.self_attention(ca_out.last_hidden_state, sa_pad_mask, frq_q, frq_q, sa_cache)
        return h, (ca_out.kv_cache,) + sa_caches


class CausalSequenceModel(PerceiverAR):
    """Perceiver AR + token input adapter + optional final LayerNorm +
    tied-embedding logits.

    :param device: where the parameters live — ``"cuda"`` by default; asking
        for CUDA without a card raises (pass ``device="cpu"``).
    :param generator: CPU ``torch.Generator`` for the random initialization
        (normal(0, ``init_scale``) projections and embeddings, zero biases,
        unit LayerNorms); a generator seeded 0 when None, so construction is
        deterministic. Weights are drawn on the CPU and then moved, so one
        seed gives the same model on every device.
    """

    def __init__(self, config: CausalSequenceModelConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        rotated = config.num_channels // config.num_heads
        if config.abs_pos_emb:
            rotated //= 2  # rotary embedding on the first half of each head's channels
        adapter = TokenInputAdapterWithRotarySupport(
            config.vocab_size, config.max_seq_len, config.num_channels,
            abs_pos_emb=config.abs_pos_emb, rotated_channels_per_head=rotated,
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
            activation_offloading=config.activation_offloading,
        )
        self.config = config
        if config.output_norm:
            self.out_norm = FusedLayerNorm(config.num_channels, LAYER_NORM_EPSILON)
        self.output_adapter = TiedTokenOutputAdapter(config.vocab_size, emb_bias=config.output_bias)
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

    def forward(self, x: torch.Tensor, prefix_len: int, pad_mask: Optional[torch.Tensor] = None,
                kv_cache: Optional[tuple] = None, decode: bool = False, sa_pad_mask=None,
                pos_shift=None, deterministic: bool = True, prefix_keep_idx=None,
                generator: Optional[torch.Generator] = None) -> CausalModelOutput:
        """Logits (B, N_latent, V) for token ids ``x`` (B, N); see
        :class:`PerceiverAR` for the call modes and the training arguments.
        ``pad_mask`` (True = left padding) is (B, N) for a forward,
        slot-aligned (B, capacity) for a decode step; ``sa_pad_mask``/
        ``pos_shift`` apply to decode steps. Differentiable without a cache;
        with one, it runs under ``torch.no_grad()``."""
        if prefix_len > self.max_prefix_len:
            raise ValueError(f"prefix_len ({prefix_len}) exceeds max_prefix_len ({self.max_prefix_len})")
        with torch.set_grad_enabled(torch.is_grad_enabled() and kv_cache is None):
            h, cache = self.perceiver_ar(x, prefix_len, pad_mask, kv_cache, decode, sa_pad_mask, pos_shift,
                                         deterministic, prefix_keep_idx, generator)
            if self.config.output_norm:
                h = self.out_norm(h)
            logits = self.output_adapter(h, attend=self.input_adapter.attend)
        return CausalModelOutput(h, logits, cache)
