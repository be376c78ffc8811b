"""Weights from the JAX package to the port.

:func:`state_dict_from_jax` renames a Flax ``CausalSequenceModel`` parameter
tree (a nested dict of numpy arrays, with or without the top ``"params"``
key) to the port's ``state_dict``. The port's parameter names are those of the
reference PyTorch implementation, so this is the same mapping as the JAX
package's ``hf/lightning_ckpt.py::export_causal_sequence_model_state_dict``:
Linear kernels are transposed (Flax stores ``(in, out)``), LayerNorm
``scale`` becomes ``weight``, embeddings keep their tables. The port never
sees a JAX array: callers convert the tree with ``np.asarray`` first.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(tree, prefix, out) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layernorm(tree, prefix, out) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _attention(tree, prefix, out) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _linear(tree[name], f"{prefix}.{name}", out)


def _mlp(tree, prefix, out) -> None:
    _layernorm(tree["LayerNorm_0"], f"{prefix}.0", out)
    _linear(tree["dense_1"], f"{prefix}.1", out)
    _linear(tree["dense_2"], f"{prefix}.3", out)


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CausalSequenceModel`` params (numpy leaves) -> the port's
    ``state_dict`` (f32 CPU tensors; ``load_state_dict`` moves them)."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    adapter = p["input_adapter"]
    out["input_adapter.txt_embedding.weight"] = _t(adapter["txt_embedding"]["embedding"])
    if "pos_embedding" in adapter:
        out["input_adapter.pos_embedding.weight"] = _t(adapter["pos_embedding"]["embedding"])
    ca = p["perceiver_ar"]["cross_attention"]
    _layernorm(ca["cross_attn"]["q_norm"], "cross_attention.0.module.q_norm", out)
    _layernorm(ca["cross_attn"]["kv_norm"], "cross_attention.0.module.kv_norm", out)
    _attention(ca["cross_attn"]["attention"], "cross_attention.0.module.attention", out)
    _mlp(ca["mlp"], "cross_attention.1.module", out)
    sa = p["perceiver_ar"]["self_attention"]
    for i in range(len(sa)):
        layer = sa[f"layer_{i}"]
        _layernorm(layer["self_attn"]["norm"], f"self_attention.{i}.0.module.norm", out)
        _attention(layer["self_attn"]["attention"], f"self_attention.{i}.0.module.attention", out)
        _mlp(layer["mlp"], f"self_attention.{i}.1.module", out)
    if "out_norm" in p:
        _layernorm(p["out_norm"], "out_norm", out)
    if "output_adapter" in p:
        out["output_adapter.bias"] = _t(p["output_adapter"]["bias"])
    return out
