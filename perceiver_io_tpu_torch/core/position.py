"""Absolute positions, rotary (RoPE) encodings and the Fourier position
encodings of image grids (counterpart of ``perceiver_io_tpu/core/position.py``).

The rotation pairs ADJACENT channels — ``rotate_half`` maps
``[x1, x2, x3, x4, ...]`` to ``[-x2, x1, -x4, x3, ...]`` and each frequency is
repeated twice — not the GPT-NeoX half split. Only the first ``R`` channels of
a head rotate (``R`` = the encoding's width); the rest pass through.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch


def positions(
    batch_size: int,
    seq_len: int,
    shift: Optional[torch.Tensor] = None,
    offset: Optional[Union[int, torch.Tensor]] = None,
    device=None,
) -> torch.Tensor:
    """Absolute position indices (B, N) int64, clamped at >= 0. ``shift``
    (B, 1) subtracts each row's left-pad count; ``offset`` (an int, or a
    (B, 1) tensor of per-row starts) adds a start position."""
    if device is None:
        device = shift.device if shift is not None else (offset.device if torch.is_tensor(offset) else "cpu")
    pos = torch.arange(seq_len, device=device, dtype=torch.int64)[None, :].expand(batch_size, seq_len)
    if offset is not None:
        pos = pos + offset
    if shift is not None:
        if tuple(shift.shape) != (batch_size, 1):
            raise ValueError(f"shift must have shape {(batch_size, 1)} but has shape {tuple(shift.shape)}")
        pos = pos - shift
    return torch.clamp(pos, min=0)


def frequency_position_encoding(abs_pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Rotary features (..., N, dim) f32: ``abs_pos * inv_freq`` with
    ``inv_freq_i = 10000 ** (-2i / dim)``, each frequency repeated twice."""
    if dim % 2 != 0:
        raise ValueError(f"rotary dim must be even but is {dim}")
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=abs_pos.device) / dim))
    enc = abs_pos.to(torch.float32)[..., None] * inv_freq
    return torch.repeat_interleave(enc, 2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[x1, x2, x3, x4, ...] -> [-x2, x1, -x4, x3, ...] over the last axis."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def apply_rotary_pos_emb(t: torch.Tensor, pos_enc: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``pos_enc.shape[-1]`` channels of ``t`` (..., N, C) in
    f32; ``pos_enc`` broadcasts to (..., N, R), R <= C."""
    rotate_dim = pos_enc.shape[-1]
    t_rot, t_pass = t[..., :rotate_dim], t[..., rotate_dim:]
    pe = pos_enc.to(torch.float32)
    t_rot32 = t_rot.to(torch.float32)
    rotated = (t_rot32 * torch.cos(pe) + rotate_half(t_rot32) * torch.sin(pe)).to(t.dtype)
    if t_pass.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, t_pass], dim=-1)


@functools.lru_cache(maxsize=16)
def fourier_position_encodings(input_shape: Sequence[int], num_frequency_bands: int,
                               include_positions: bool = True) -> np.ndarray:
    """Fourier features over an N-dimensional grid in [-1, 1]: a
    (prod(input_shape), C) float32 array, C = len(input_shape) * (2 *
    num_frequency_bands + include_positions), channels ordered [raw
    positions, sin per dim, cos per dim]. Computed in numpy, memoized per
    grid (the port's own copy of the JAX package's function)."""
    input_shape = tuple(input_shape)
    coords = [np.linspace(-1.0, 1.0, num=s, dtype=np.float32) for s in input_shape]
    pos = np.stack(np.meshgrid(*coords, indexing="ij"), axis=-1)  # (*shape, ndim)
    grids = [pos[..., i:i + 1] * np.linspace(1.0, size / 2.0, num=num_frequency_bands, dtype=np.float32)
             for i, size in enumerate(input_shape)]
    encodings = [pos] if include_positions else []
    encodings.extend(np.sin(math.pi * g) for g in grids)
    encodings.extend(np.cos(math.pi * g) for g in grids)
    enc = np.concatenate(encodings, axis=-1)
    return enc.reshape(-1, enc.shape[-1])


class FourierPositionEncoding:
    """Stateless provider of flattened Fourier position encodings for a
    grid."""

    def __init__(self, input_shape: Sequence[int], num_frequency_bands: int):
        self.input_shape = tuple(input_shape)
        self.num_frequency_bands = num_frequency_bands

    def num_position_encoding_channels(self, include_positions: bool = True) -> int:
        return len(self.input_shape) * (2 * self.num_frequency_bands + include_positions)

    def __call__(self, batch_size: int, device=None) -> torch.Tensor:
        """(batch_size, prod(input_shape), C) f32, a broadcast view."""
        enc = torch.from_numpy(fourier_position_encodings(self.input_shape, self.num_frequency_bands))
        return enc.to(device)[None].expand(batch_size, *enc.shape)
