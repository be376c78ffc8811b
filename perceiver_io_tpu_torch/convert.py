"""Weights from the JAX package to the port.

:func:`state_dict_from_jax` renames a Flax ``CausalSequenceModel`` parameter
tree (a nested dict of numpy arrays, with or without the top ``"params"``
key) to the port's ``state_dict`` (:func:`symbolic_audio_state_dict_from_jax`
under the symbolic audio model's name); ``*_state_dict_from_jax`` do the same for
the Perceiver IO task models (the image and text classifiers, the masked
LM, optical flow, the time-series forecaster). The port's parameter names are those of the
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


def _cross_attention_layer(tree, prefix, out, residual: bool = True) -> None:
    """A ``CrossAttentionLayer``: its attention sits in a Residual
    (``{prefix}.0.module``) unless the layer was built with
    ``attention_residual=False`` (``{prefix}.0``)."""
    ca = tree["cross_attn"]
    a = f"{prefix}.0.module" if residual else f"{prefix}.0"
    _layernorm(ca["q_norm"], f"{a}.q_norm", out)
    _layernorm(ca["kv_norm"], f"{a}.kv_norm", out)
    _attention(ca["attention"], f"{a}.attention", out)
    _mlp(tree["mlp"], f"{prefix}.1.module", out)


def _self_attention_block(tree, prefix, out) -> None:
    for i in range(len(tree)):
        layer = tree[f"layer_{i}"]
        _layernorm(layer["self_attn"]["norm"], f"{prefix}.{i}.0.module.norm", out)
        _attention(layer["self_attn"]["attention"], f"{prefix}.{i}.0.module.attention", out)
        _mlp(layer["mlp"], f"{prefix}.{i}.1.module", out)


def _encoder(enc, prefix: str, out) -> None:
    """A ``PerceiverEncoder`` (its input adapter apart): the latent array,
    ``cross_attn_1``/``self_attn_1`` and the optional unshared
    ``cross_attn_n``/``self_attn_n``."""
    out[f"{prefix}.latent_provider._query"] = _t(enc["latent_provider"]["query"])
    for name in ("cross_attn_1", "cross_attn_n"):
        if name in enc:
            _cross_attention_layer(enc[name], f"{prefix}.{name}", out)
    for name in ("self_attn_1", "self_attn_n"):
        if name in enc:
            _self_attention_block(enc[name], f"{prefix}.{name}", out)


def _decoder(dec, prefix: str, out, residual: bool) -> None:
    """A ``PerceiverDecoder``'s cross-attention layer, and its trainable
    query array and linear output adapter where it has them."""
    _cross_attention_layer(dec["cross_attn"], f"{prefix}.cross_attn", out, residual)
    if "output_query_provider" in dec:
        out[f"{prefix}.output_query_provider._query"] = _t(dec["output_query_provider"]["query"])
    if "output_adapter" in dec:
        _linear(dec["output_adapter"]["linear"], f"{prefix}.output_adapter.linear", out)


def _token_input_adapter(adapter, prefix: str, out) -> None:
    out[f"{prefix}.txt_embedding.weight"] = _t(adapter["txt_embedding"]["embedding"])
    if "pos_embedding" in adapter:
        out[f"{prefix}.pos_embedding.weight"] = _t(adapter["pos_embedding"]["embedding"])


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
    out: Dict[str, torch.Tensor] = {}
    _encoder(p["encoder"], "0", out)
    _decoder(p["decoder"], "1", out, residual=True)
    return out


def text_classifier_state_dict_from_jax(params: Dict[str, Any], decoder_residual: bool = True
                                        ) -> Dict[str, torch.Tensor]:
    """Flax ``TextClassifier`` params -> the port's ``state_dict``: the image
    classifier's names plus the token adapter's
    (``0.input_adapter.txt_embedding.weight``,
    ``0.input_adapter.pos_embedding.weight``), which JAX holds at the top of
    its tree. ``decoder_residual``: the decoder's ``cross_attention_residual``
    (the JAX tree does not tell it; the port's names do)."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _token_input_adapter(p["input_adapter"], "0.input_adapter", out)
    _encoder(p["encoder"], "0", out)
    _decoder(p["decoder"], "1", out, decoder_residual)
    return out


def mlm_state_dict_from_jax(params: Dict[str, Any], decoder_residual: bool = True) -> Dict[str, torch.Tensor]:
    """Flax ``MaskedLanguageModel`` params -> the port's ``state_dict``: the
    text classifier's names, and the output adapter JAX holds at the top of
    its tree: ``1.output_adapter.bias`` (tied logits) or
    ``1.output_adapter.linear.*`` (the independent head).
    ``deepmind/language-perceiver``'s decoder has no attention residual."""
    p = params.get("params", params)
    out = text_classifier_state_dict_from_jax(p, decoder_residual)
    head = p.get("output_adapter", {})
    if "linear" in head:
        _linear(head["linear"], "1.output_adapter.linear", out)
    elif "bias" in head:
        out["1.output_adapter.bias"] = _t(head["bias"])
    return out


def optical_flow_state_dict_from_jax(params: Dict[str, Any], decoder_residual: bool = True
                                     ) -> Dict[str, torch.Tensor]:
    """Flax ``OpticalFlow`` params -> the port's ``state_dict``: the patch
    projection (``0.input_adapter.linear.*``, at the top of JAX's tree), the
    encoder, the decoder's cross-attention and its output head
    (``1.output_adapter.linear.*``); the queries are the adapted input, so
    no query array. ``deepmind/optical-flow-perceiver``'s decoder has no
    attention residual."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _linear(p["input_adapter"]["linear"], "0.input_adapter.linear", out)
    _encoder(p["encoder"], "0", out)
    _decoder(p["decoder"], "1", out, decoder_residual)
    return out


def timeseries_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``TimeSeriesPerceiver`` params -> the port's ``state_dict``, under
    the reference application's names: ``encoder.input_adapter.linear.*``,
    ``encoder.input_adapter.pos_proj.weight`` (bias-free), ``encoder.*`` and
    ``decoder.*``."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _linear(p["input_adapter"]["linear"], "encoder.input_adapter.linear", out)
    _linear(p["input_adapter"]["pos_proj"], "encoder.input_adapter.pos_proj", out)
    _encoder(p["encoder"], "encoder", out)
    _decoder(p["decoder"], "decoder", out, residual=True)
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


def symbolic_audio_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``SymbolicAudioModel`` params -> the port's ``state_dict``: the
    symbolic audio model is a causal sequence model over the MIDI event
    vocabulary, so this is :func:`state_dict_from_jax`."""
    return state_dict_from_jax(params)


def jax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """``{port parameter name: the JAX package's path of its counterpart}``
    (``"params/perceiver_ar/cross_attention/cross_attn/q_norm/scale"``, ...):
    the inverse of the renamings above, read off the port's module tree, for
    a causal sequence model (the CLM, the symbolic audio model) or any of
    the Perceiver IO task models. The
    encoder's input adapter and the masked LM's token output adapter sit at
    the top of JAX's tree."""
    from torch import nn

    from perceiver_io_tpu_torch.core import modules
    from perceiver_io_tpu_torch.core.adapter import TiedTokenOutputAdapter, TokenOutputAdapter, TrainableQueryProvider
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
            top = ((isinstance(module, modules.PerceiverEncoder) and name == "input_adapter")
                   or isinstance(sub, (TiedTokenOutputAdapter, TokenOutputAdapter)) and name == "output_adapter"
                   and isinstance(module, modules.PerceiverDecoder))
            walk(sub, f"{port}{name}.", f"params/{name}/" if top else jax + child(module, name))

    walk(model, "", "params/")
    return out
