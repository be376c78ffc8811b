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


def _cross_attention_layer(tree, prefix, out) -> None:
    """A ``CrossAttentionLayer`` whose attention sits in a Residual (the
    layer's default ``attention_residual=True``)."""
    ca = tree["cross_attn"]
    _layernorm(ca["q_norm"], f"{prefix}.0.module.q_norm", out)
    _layernorm(ca["kv_norm"], f"{prefix}.0.module.kv_norm", out)
    _attention(ca["attention"], f"{prefix}.0.module.attention", out)
    _mlp(tree["mlp"], f"{prefix}.1.module", out)


def _self_attention_block(tree, prefix, out) -> None:
    for i in range(len(tree)):
        layer = tree[f"layer_{i}"]
        _layernorm(layer["self_attn"]["norm"], f"{prefix}.{i}.0.module.norm", out)
        _attention(layer["self_attn"]["attention"], f"{prefix}.{i}.0.module.attention", out)
        _mlp(layer["mlp"], f"{prefix}.{i}.1.module", out)


def image_classifier_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ImageClassifier`` params (numpy leaves) -> the port's
    ``state_dict``, under the reference names (``0.latent_provider._query``,
    ``0.cross_attn_1.0.module.*``, ``0.self_attn_1.{i}.*``, optional
    ``0.cross_attn_n``/``0.self_attn_n``, ``1.cross_attn.*``,
    ``1.output_query_provider._query``, ``1.output_adapter.linear.*``). The
    image input adapter has no parameters. The decoder's cross-attention is
    taken with its residual (``cross_attention_residual=True``, the
    default)."""
    p = params.get("params", params)
    enc, dec = p["encoder"], p["decoder"]
    out: Dict[str, torch.Tensor] = {"0.latent_provider._query": _t(enc["latent_provider"]["query"])}
    for name in ("cross_attn_1", "cross_attn_n"):
        if name in enc:
            _cross_attention_layer(enc[name], f"0.{name}", out)
    for name in ("self_attn_1", "self_attn_n"):
        if name in enc:
            _self_attention_block(enc[name], f"0.{name}", out)
    _cross_attention_layer(dec["cross_attn"], "1.cross_attn", out)
    out["1.output_query_provider._query"] = _t(dec["output_query_provider"]["query"])
    _linear(dec["output_adapter"]["linear"], "1.output_adapter.linear", out)
    return out


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CausalSequenceModel`` params (numpy leaves) -> the port's
    ``state_dict`` (f32 CPU tensors; ``load_state_dict`` moves them)."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    adapter = p["input_adapter"]
    out["input_adapter.txt_embedding.weight"] = _t(adapter["txt_embedding"]["embedding"])
    if "pos_embedding" in adapter:
        out["input_adapter.pos_embedding.weight"] = _t(adapter["pos_embedding"]["embedding"])
    _cross_attention_layer(p["perceiver_ar"]["cross_attention"], "cross_attention", out)
    _self_attention_block(p["perceiver_ar"]["self_attention"], "self_attention", out)
    if "out_norm" in p:
        _layernorm(p["out_norm"], "out_norm", out)
    if "output_adapter" in p:
        out["output_adapter.bias"] = _t(p["output_adapter"]["bias"])
    return out
