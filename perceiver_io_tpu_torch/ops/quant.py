"""Weight-only int8 quantization for the decode path (counterpart of
``perceiver_io_tpu/ops/quant.py``).

A decode step reads every projection and MLP weight once a token; int8
storage with one float32 scale an output channel holds those weights in a
quarter of their f32 bytes (half of bf16's). The generation entry points take
it as ``weight_dtype=torch.int8`` (``generation``): the prompt pass runs on
the float weights, and each decode step dequantizes the int8 weights to the
model's compute dtype inside the step (inside the captured CUDA graph on the
card, so on every replay), as the JAX package dequantizes inside its scan
body. The port has no fused int8 product: the dequantized weights are
written to memory once a step and the products read them.

Scales are float32 and quantization rounds against the stored scale. Only
matmul weights are quantized: the ``weight`` of every ``nn.Linear`` (Flax's
``kernel`` leaves). Embeddings, LayerNorm parameters and biases stay float,
and so does the tied logit head, which reads the token table.

A torch ``nn.Linear.weight`` is ``(out, in)``, the transpose of Flax's
``(in, out)`` kernel, so the per-output-channel reduction runs over ``dim=1``
and ``q``/``scale`` are JAX's ``q.T``/``scale.T`` on the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn


@dataclass
class QuantizedTensor:
    """int8 values ``q`` (out, in) and a float32 per-output-channel
    ``scale`` (out, 1); ``w ~= q * scale``."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def quantize_tensor(w: torch.Tensor, out: Optional[QuantizedTensor] = None) -> QuantizedTensor:
    """Symmetric per-output-channel int8 of a weight ``(out, in)``: one scale
    a row, ``absmax.clamp_min(1e-12) / 127``, values rounded half to even
    against it and clipped to ±127. With ``out`` the result is written into
    its tensors in place (their addresses stay) and ``out`` returned."""
    w32 = w.detach().float()
    scale = w32.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(w32 / scale).clamp_(-127, 127).to(torch.int8)
    if out is None:
        return QuantizedTensor(q, scale)
    out.q.copy_(q)
    out.scale.copy_(scale)
    return out


def quantized_linears(model: nn.Module, min_size: int = 0) -> Dict[str, nn.Linear]:
    """The ``nn.Linear`` modules whose weights :func:`quantize_weights`
    quantizes, by the name of their ``weight`` in ``model.state_dict()``:
    every 2-D weight of at least ``min_size`` elements."""
    return {f"{name}.weight" if name else "weight": m for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and m.weight.dim() >= 2 and m.weight.numel() >= min_size}


@torch.no_grad()
def quantize_weights(model: nn.Module, min_size: int = 0) -> Dict[str, QuantizedTensor]:
    """:func:`quantize_tensor` of every matmul weight of ``model``
    (:func:`quantized_linears`), keyed by its ``state_dict`` name. The other
    parameters are not in the result: they stay the model's own."""
    return {name: quantize_tensor(m.weight) for name, m in quantized_linears(model, min_size).items()}


def dequantize_weights(qweights: Dict[str, QuantizedTensor], dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_weights`: each entry as a ``dtype``
    tensor, ``(q.float() * scale).to(dtype)``."""
    return {name: qt.dequantize(dtype) for name, qt in qweights.items()}
