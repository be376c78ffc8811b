"""Query providers and input/output adapters (counterpart of
``perceiver_io_tpu/core/adapter.py``): the trainable query array, the token
input adapter and its rotary variant, the tied and the independent token
output adapters and the classification head. Parameter names follow the reference PyTorch
implementation: ``_query``, ``txt_embedding.weight``,
``pos_embedding.weight``, ``bias``, ``linear.weight``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.core.attention import dense
from perceiver_io_tpu_torch.core.position import frequency_position_encoding, positions


class _RowLookup(torch.autograd.Function):
    """``F.embedding(ids, weight)`` whose weight gradient sums each row's
    contributions in an order fixed by the indices: on CUDA ``index_put_``
    with accumulation, which sorts them; on the CPU ``index_add_``, which
    takes them in order (the CPU's ``index_put_`` accumulates in an order
    that moves). The CUDA backward of ``F.embedding`` takes more than 3072
    indices in an order that moves from call to call, so the card's CLM
    gradient was not reproducible at the flagship's shapes (PERF.md)."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        c = grad.shape[-1]
        ids, grad = ids.reshape(-1), grad.reshape(-1, c)
        dw = grad.new_zeros((ctx.rows, c))
        if grad.is_cuda:
            return None, dw.index_put_((ids,), grad, accumulate=True)
        return None, dw.index_add_(0, ids, grad)


def lookup(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding table, with a gradient that repeats bit
    for bit (:class:`_RowLookup`)."""
    return _RowLookup.apply(ids, table.weight)


class TrainableQueryProvider(nn.Module):
    """Learnable cross-attention query array: the latent array of a Perceiver
    IO encoder and the output query of a decoder. ``forward()`` returns it
    as (1, N, C) in the compute ``dtype`` (the parameter stays f32, as
    JAX's ``query.astype(self.dtype)``)."""

    def __init__(self, num_queries: int, num_query_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_query_channels = num_query_channels
        self.dtype = dtype
        self._query = nn.Parameter(torch.zeros(num_queries, num_query_channels))

    def forward(self, x=None) -> torch.Tensor:
        return self._query.to(self.dtype)[None]


class ClassificationOutputAdapter(nn.Module):
    """Linear head over the decoder output, in the compute ``dtype``
    (:func:`core.attention.dense`); squeezes a single output query:
    (B, 1, C) -> (B, num_classes)."""

    def __init__(self, num_classes: int, num_output_query_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(num_output_query_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(self.linear, x, self.dtype)
        return x[:, 0] if x.shape[1] == 1 else x


class TokenInputAdapter(nn.Module):
    """Token embedding + (optional) learned absolute position embedding:
    ``forward(x, abs_pos=None)`` gives (B, N, C) in the compute dtype.

    With ``abs_pos=None`` the positions are ``arange(N)`` and the position rows
    are a table slice (positions past the table repeat its last row);
    otherwise they are looked up, right-aligned to ``x`` and clipped to the
    table.

    ``dtype``: the compute dtype (Flax's ``nn.Embed(dtype=...)``). The f32
    rows are looked up, then cast, and the token and position rows added in
    ``dtype``: the forward of JAX's cast-then-look-up, since a cast commutes
    with a row gather. The tables' gradients sum in f32
    (:func:`lookup`), where JAX's one-hot contraction sums them in its
    bf16 matrix product.
    """

    def __init__(self, vocab_size: int, max_seq_len: int, num_input_channels: int,
                 abs_pos_emb: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.num_input_channels = num_input_channels
        self.abs_pos_emb = abs_pos_emb
        self.txt_embedding = nn.Embedding(vocab_size, num_input_channels)
        if abs_pos_emb:
            self.pos_embedding = nn.Embedding(max_seq_len, num_input_channels)

    def _pos_slice(self, n: int) -> torch.Tensor:
        table = self.pos_embedding.weight
        pos_emb = table[: min(n, self.max_seq_len)]
        if n > self.max_seq_len:
            tail = table[-1:].expand(n - self.max_seq_len, table.shape[1])
            pos_emb = torch.cat([pos_emb, tail], dim=0)
        return pos_emb

    def embed(self, x: torch.Tensor, abs_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        tok = lookup(self.txt_embedding, x).to(dt)
        if not self.abs_pos_emb:
            return tok
        if abs_pos is None:
            return tok + self._pos_slice(x.shape[1])[None].to(dt)
        if x.shape[1] < abs_pos.shape[1]:
            abs_pos = abs_pos[:, -x.shape[1]:]
        abs_pos = torch.clamp(abs_pos, 0, self.max_seq_len - 1)
        return tok + lookup(self.pos_embedding, abs_pos).to(dt)

    def forward(self, x: torch.Tensor, abs_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embed(x, abs_pos)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits against the tied token embedding (``x @ E^T``), in the
        compute dtype (Flax's ``Embed.attend``)."""
        return x.to(self.dtype) @ self.txt_embedding.weight.to(self.dtype).t()


class TokenInputAdapterWithRotarySupport(TokenInputAdapter):
    """:class:`TokenInputAdapter` that also gives the rotary frequency
    encoding of the same absolute positions: ``forward(x, abs_pos)`` returns
    ``(embedded, frq_pos_enc)``; the frequency encoding follows the full,
    unclipped ``abs_pos``. Its parameters are its base class's
    (``txt_embedding.weight``, ``pos_embedding.weight``)."""

    def __init__(self, vocab_size: int, max_seq_len: int, num_input_channels: int,
                 abs_pos_emb: bool = True, rotated_channels_per_head: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, max_seq_len, num_input_channels, abs_pos_emb, dtype)
        self.rotated_channels_per_head = rotated_channels_per_head

    def forward(self, x: torch.Tensor, abs_pos: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        embedded = self.embed(x, abs_pos)
        if abs_pos is None:
            abs_pos = positions(x.shape[0], x.shape[1], device=x.device)
        return embedded, frequency_position_encoding(abs_pos, self.rotated_channels_per_head)

    def embed_compact(self, x: torch.Tensor, keep_idx: torch.Tensor,
                      prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed the compact ``[kept prefix; latents]`` sequence straight from
        token ids: the prefix-dropout selection applied before embedding.

        ``x`` (B, N) token ids at positions ``arange(N)`` (no padding);
        ``keep_idx`` (B, K) the sorted unique prefix keep set. Returns
        ``(embedded, frq)`` of length ``K + N - prefix_len``: the rows
        ``forward(x)`` would give at ``[keep_idx; prefix_len..N)``, with the
        frequency encoding at those absolute positions."""
        b, n = x.shape
        ids = torch.cat([torch.gather(x[:, :prefix_len], 1, keep_idx), x[:, prefix_len:]], dim=1)
        emb = lookup(self.txt_embedding, ids).to(self.dtype)
        if self.abs_pos_emb:
            pos = self._pos_slice(n)
            pos_latent = pos[prefix_len:][None].expand(b, n - prefix_len, pos.shape[1])
            emb = emb + torch.cat([pos[:prefix_len][keep_idx], pos_latent], dim=1).to(self.dtype)
        latent_pos = torch.arange(prefix_len, n, device=x.device)[None].expand(b, n - prefix_len)
        abs_pos = torch.cat([keep_idx, latent_pos], dim=1)
        return emb, frequency_position_encoding(abs_pos, self.rotated_channels_per_head)


class TiedTokenOutputAdapter(nn.Module):
    """Logits tied to the token embedding: ``attend(x) (+ bias)``; the table
    stays owned by the input adapter."""

    def __init__(self, vocab_size: int, emb_bias: bool = True):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab_size)) if emb_bias else None

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        logits = attend(x)
        if self.bias is not None:
            logits = logits + self.bias.to(logits.dtype)
        return logits


class TokenOutputAdapter(nn.Module):
    """Independent (untied) linear head to vocab logits, in the compute
    ``dtype`` (:func:`core.attention.dense`)."""

    def __init__(self, vocab_size: int, num_output_query_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(num_output_query_channels, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.linear, x, self.dtype)
