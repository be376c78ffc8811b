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


def jax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """``{port parameter name: the JAX package's path of its counterpart}``
    (``"params/perceiver_ar/cross_attention/cross_attn/q_norm/scale"``, ...):
    the inverse of the renamings above, read off the port's module tree, for
    a causal sequence model or an image classifier."""
    from torch import nn

    from perceiver_io_tpu_torch.core import modules
    from perceiver_io_tpu_torch.core.adapter import TrainableQueryProvider
    from perceiver_io_tpu_torch.ops.layernorm import FusedLayerNorm

    def child(parent: nn.Module, name: str) -> str:
        """The JAX segments of ``parent``'s child ``name`` (with a trailing
        slash; empty for a ``Residual``'s ``module``)."""
        if isinstance(parent, modules.Residual):
            return ""
        if isinstance(parent, modules.CrossAttentionLayer):
            return "cross_attn/" if name == "0" else "mlp/"
        if isinstance(parent, modules.SelfAttentionLayer):
            return "self_attn/" if name == "0" else "mlp/"
        if isinstance(parent, modules.SelfAttentionBlock):
            return f"layer_{name}/"
        if isinstance(parent, modules.MLP):
            return {"0": "LayerNorm_0/", "1": "dense_1/", "3": "dense_2/"}.get(name, name + "/")
        if isinstance(parent, modules.PerceiverIO):
            return {"0": "encoder/", "1": "decoder/"}[name]
        if isinstance(parent, modules.PerceiverAR) and name in ("cross_attention", "self_attention"):
            return f"perceiver_ar/{name}/"
        return name + "/"

    def leaf(module: nn.Module, name: str) -> str:
        if isinstance(module, FusedLayerNorm) and name == "weight":
            return "scale"
        if isinstance(module, nn.Linear) and name == "weight":
            return "kernel"
        if isinstance(module, nn.Embedding):
            return "embedding"
        if isinstance(module, TrainableQueryProvider):
            return "query"
        return name

    out: Dict[str, str] = {}

    def walk(module: nn.Module, port: str, jax: str) -> None:
        for name, _ in module.named_parameters(recurse=False):
            out[port + name] = jax + leaf(module, name)
        for name, sub in module.named_children():
            walk(sub, f"{port}{name}.", jax + child(module, name))

    walk(model, "", "params/")
    return out
