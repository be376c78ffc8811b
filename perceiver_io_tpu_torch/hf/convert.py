"""Weight conversion from Hugging Face ``transformers`` Perceiver models into
the port's models (counterpart of ``perceiver_io_tpu/hf/convert.py``).

Parity with the reference conversion seam
(reference: perceiver/model/core/huggingface.py:21-80,
perceiver/model/text/mlm/huggingface.py:118-165,
perceiver/model/vision/image_classifier/huggingface.py:181-234,
perceiver/model/vision/optical_flow/huggingface.py:130-203): the same
official DeepMind checkpoints (``deepmind/language-perceiver``,
``deepmind/vision-perceiver-fourier``, ``deepmind/optical-flow-perceiver``)
convert into the port's models with numerically equivalent predictions.

The converters take any object with a ``transformers`` Perceiver ``config``
and a ``state_dict()`` (name -> tensor): a downloaded checkpoint or a locally
instantiated ``transformers`` model. They import no ``transformers``. The
mapping from HF names to the JAX package's parameter tree is a numpy copy of
the JAX module's; the port's ``convert.*_state_dict_from_jax`` converters take
the tree to the port's names, so no parameter name is restated here. Each
model converter returns ``(config, model)``, the model built on ``device``
(``"cuda"`` by default) with its weights loaded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from perceiver_io_tpu_torch import convert
from perceiver_io_tpu_torch.device import DeviceLike


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _linear(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _attention(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """q/k/v/o projections of one HF ``PerceiverLayer`` attention
    (reference: core/huggingface.py:30-35)."""
    return {
        "q_proj": _linear(sd, f"{prefix}.self.query"),
        "k_proj": _linear(sd, f"{prefix}.self.key"),
        "v_proj": _linear(sd, f"{prefix}.self.value"),
        "o_proj": _linear(sd, f"{prefix}.output.dense"),
    }


def _mlp(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """HF PerceiverLayer layernorm+MLP -> the MLP subtree (LayerNorm_0, dense_1, dense_2)."""
    return {
        "LayerNorm_0": _layernorm(sd, f"{prefix}.layernorm"),
        "dense_1": _linear(sd, f"{prefix}.mlp.dense1"),
        "dense_2": _linear(sd, f"{prefix}.mlp.dense2"),
    }


def cross_attention_layer_params(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """One HF cross-attention PerceiverLayer -> a ``CrossAttentionLayer`` subtree
    (layernorm1 = query norm, layernorm2 = key/value norm;
    reference: core/huggingface.py:43-52)."""
    return {
        "cross_attn": {
            "q_norm": _layernorm(sd, f"{prefix}.attention.self.layernorm1"),
            "kv_norm": _layernorm(sd, f"{prefix}.attention.self.layernorm2"),
            "attention": _attention(sd, f"{prefix}.attention"),
        },
        "mlp": _mlp(sd, prefix),
    }


def self_attention_layer_params(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """One HF self-attention PerceiverLayer -> a ``SelfAttentionLayer`` subtree
    (reference: core/huggingface.py:55-62)."""
    return {
        "self_attn": {
            "norm": _layernorm(sd, f"{prefix}.attention.self.layernorm1"),
            "attention": _attention(sd, f"{prefix}.attention"),
        },
        "mlp": _mlp(sd, prefix),
    }


def self_attention_block_params(sd: Dict[str, Any], prefix: str, num_layers: int) -> Dict[str, Any]:
    return {
        f"layer_{i}": self_attention_layer_params(sd, f"{prefix}.{i}") for i in range(num_layers)
    }


def perceiver_encoder_params(
    sd: Dict[str, Any], num_self_attention_layers: int, prefix: str = "perceiver"
) -> Dict[str, Any]:
    """HF ``PerceiverModel`` encoder -> a ``PerceiverEncoder`` subtree
    (latents + cross_attn_1 + self_attn_1; official models use one
    cross-attention layer and weight-shared repeated blocks, which the
    encoder reuses from the same parameters)."""
    return {
        "latent_provider": {"query": _np(sd[f"{prefix}.embeddings.latents"])},
        "cross_attn_1": cross_attention_layer_params(sd, f"{prefix}.encoder.cross_attention"),
        "self_attn_1": self_attention_block_params(
            sd, f"{prefix}.encoder.self_attends", num_self_attention_layers
        ),
    }


def _encoder_channels(hf_config, kv_dim: int):
    """Resolve the HF channel defaults (transformers PerceiverAttention:
    cross-attention qk defaults to the KV width under
    ``cross_attention_shape_for_attention="kv"``, self-attention to
    ``d_latents``; v defaults to qk). Returns
    (qk_cross, v_cross, qk_self, v_self) as explicit ints so the models don't
    fall back to their own defaults."""
    qk_ca = hf_config.qk_channels
    if qk_ca is None:
        shape_for = getattr(hf_config, "cross_attention_shape_for_attention", "kv")
        qk_ca = kv_dim if shape_for == "kv" else hf_config.d_latents
    v_ca = hf_config.v_channels if hf_config.v_channels is not None else qk_ca
    qk_sa = hf_config.qk_channels if hf_config.qk_channels is not None else hf_config.d_latents
    v_sa = hf_config.v_channels if hf_config.v_channels is not None else qk_sa
    return qk_ca, v_ca, qk_sa, v_sa


# -------------------------------------------------------------------------------------------
# Masked language model (deepmind/language-perceiver)
# -------------------------------------------------------------------------------------------


def convert_mlm_config(hf_config):
    """``transformers.PerceiverConfig`` -> ``MaskedLanguageModelConfig``
    (reference: text/mlm/huggingface.py:118-157)."""
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
    from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModelConfig, TextDecoderConfig

    assert hf_config.hidden_act == "gelu"
    assert hf_config.tie_word_embeddings

    qk_ca, v_ca, qk_sa, v_sa = _encoder_channels(hf_config, kv_dim=hf_config.d_model)
    encoder = TextEncoderConfig(
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        num_input_channels=hf_config.d_model,
        num_cross_attention_qk_channels=qk_ca,
        num_cross_attention_v_channels=v_ca,
        num_cross_attention_heads=hf_config.num_cross_attention_heads,
        num_self_attention_qk_channels=qk_sa,
        num_self_attention_v_channels=v_sa,
        num_self_attention_heads=hf_config.num_self_attention_heads,
        num_self_attention_layers_per_block=hf_config.num_self_attends_per_block,
        num_self_attention_blocks=hf_config.num_blocks,
        cross_attention_widening_factor=hf_config.cross_attention_widening_factor,
        self_attention_widening_factor=hf_config.self_attention_widening_factor,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
    )
    # HF hardcodes the MLM decoder attention: qk_channels=8*32, v=d_model,
    # 8 heads, MLP widening 1 (transformers PerceiverForMaskedLM.__init__ +
    # PerceiverBasicDecoder defaults) — independent of the encoder config
    decoder = TextDecoderConfig(
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        num_cross_attention_qk_channels=8 * 32,
        num_cross_attention_v_channels=hf_config.d_model,
        num_cross_attention_heads=8,
        cross_attention_widening_factor=1,
        cross_attention_residual=False,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
    )
    return MaskedLanguageModelConfig(
        encoder=encoder,
        decoder=decoder,
        num_latents=hf_config.num_latents,
        num_latent_channels=hf_config.d_latents,
    )


def _loaded(model_cls, config, state_dict, device: DeviceLike, dtype: Optional[torch.dtype]):
    kwargs = {} if dtype is None else {"dtype": dtype}
    model = model_cls(config, device=device, **kwargs)
    model.load_state_dict(state_dict, strict=True)
    return config, model


def convert_masked_language_model(hf_model, *, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None):
    """``transformers.PerceiverForMaskedLM`` -> (the port's config, its
    ``MaskedLanguageModel`` on ``device``).

    Covers the full parameter set: token + position embeddings, encoder,
    decoding cross-attention, learned output queries, and the tied-embedding
    output bias (reference: text/mlm/huggingface.py:102-165)."""
    config = convert_mlm_config(hf_model.config)
    sd = dict(hf_model.state_dict())

    n_layers = config.encoder.num_self_attention_layers_per_block
    params = {
        "input_adapter": {
            "txt_embedding": {"embedding": _np(sd["perceiver.input_preprocessor.embeddings.weight"])},
            "pos_embedding": {
                "embedding": _np(sd["perceiver.input_preprocessor.position_embeddings.weight"])
            },
        },
        "encoder": perceiver_encoder_params(sd, n_layers),
        "decoder": {
            "cross_attn": cross_attention_layer_params(sd, "perceiver.decoder.decoding_cross_attention"),
            "output_query_provider": {
                "query": _np(sd["perceiver.decoder.output_position_encodings.position_embeddings"])
            },
        },
        "output_adapter": {"bias": _np(sd["embedding_decoder.bias"])},
    }
    from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel

    return _loaded(MaskedLanguageModel, config, convert.mlm_state_dict_from_jax(params, decoder_residual=False),
                   device, dtype)


# -------------------------------------------------------------------------------------------
# Image classifier (deepmind/vision-perceiver-fourier)
# -------------------------------------------------------------------------------------------


def convert_image_classifier_config(hf_config, image_shape=(224, 224, 3), num_frequency_bands=64):
    """``transformers.PerceiverConfig`` -> ``ImageClassifierConfig``
    (reference: vision/image_classifier/huggingface.py:181-210). The 224x224
    grid and 64 Fourier bands are fixed inside the HF
    ``PerceiverForImageClassificationFourier`` preprocessor."""
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision.image_classifier import ImageClassifierConfig, ImageEncoderConfig

    assert hf_config.hidden_act == "gelu"

    image_shape = tuple(image_shape)
    # adapter width: pixels + fourier features (= HF preprocessor.num_channels)
    ndim = len(image_shape) - 1
    kv_dim = image_shape[-1] + ndim * (2 * num_frequency_bands + 1)
    qk_ca, v_ca, qk_sa, v_sa = _encoder_channels(hf_config, kv_dim=kv_dim)

    encoder = ImageEncoderConfig(
        image_shape=image_shape,
        num_frequency_bands=num_frequency_bands,
        num_cross_attention_qk_channels=qk_ca,
        num_cross_attention_v_channels=v_ca,
        num_cross_attention_heads=hf_config.num_cross_attention_heads,
        num_self_attention_qk_channels=qk_sa,
        num_self_attention_v_channels=v_sa,
        num_self_attention_heads=hf_config.num_self_attention_heads,
        num_self_attention_layers_per_block=hf_config.num_self_attends_per_block,
        num_self_attention_blocks=hf_config.num_blocks,
        cross_attention_widening_factor=hf_config.cross_attention_widening_factor,
        self_attention_widening_factor=hf_config.self_attention_widening_factor,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
    )
    # HF classification decoder: qk = v = d_latents, 1 head, MLP widening 1
    # (PerceiverBasicDecoder defaults) — independent of the encoder config
    decoder = ClassificationDecoderConfig(
        num_classes=hf_config.num_labels,
        num_output_query_channels=hf_config.d_latents,
        num_cross_attention_qk_channels=hf_config.d_latents,
        num_cross_attention_v_channels=hf_config.d_latents,
        num_cross_attention_heads=1,
        cross_attention_widening_factor=1,
        cross_attention_residual=True,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
    )
    return ImageClassifierConfig(
        encoder=encoder,
        decoder=decoder,
        num_latents=hf_config.num_latents,
        num_latent_channels=hf_config.d_latents,
    )


def convert_image_classifier(hf_model, image_shape=(224, 224, 3), num_frequency_bands=64, *,
                             device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None):
    """``transformers.PerceiverForImageClassificationFourier`` -> (config,
    the port's ``ImageClassifier`` on ``device``).

    The classification decoder: decoding cross-attention + 1 learned output
    query + final linear head
    (reference: core/huggingface.py:77-83, vision/image_classifier/huggingface.py:212-234)."""
    config = convert_image_classifier_config(hf_model.config, image_shape, num_frequency_bands)
    sd = dict(hf_model.state_dict())

    n_layers = config.encoder.num_self_attention_layers_per_block
    params = {
        "encoder": perceiver_encoder_params(sd, n_layers),
        "decoder": {
            "cross_attn": cross_attention_layer_params(
                sd, "perceiver.decoder.decoder.decoding_cross_attention"
            ),
            "output_query_provider": {
                "query": _np(
                    sd["perceiver.decoder.decoder.output_position_encodings.position_embeddings"]
                )
            },
            "output_adapter": {"linear": _linear(sd, "perceiver.decoder.decoder.final_layer")},
        },
    }
    from perceiver_io_tpu_torch.models.vision.image_classifier import ImageClassifier

    return _loaded(ImageClassifier, config, convert.image_classifier_state_dict_from_jax(params), device, dtype)


# -------------------------------------------------------------------------------------------
# Optical flow (deepmind/optical-flow-perceiver)
# -------------------------------------------------------------------------------------------


def convert_optical_flow_config(hf_config, image_shape: Optional[tuple] = None):
    """``transformers.PerceiverConfig`` -> ``OpticalFlowConfig``
    (reference: vision/optical_flow/huggingface.py:130-168)."""
    from perceiver_io_tpu_torch.models.vision.optical_flow import (
        OpticalFlowConfig,
        OpticalFlowDecoderConfig,
        OpticalFlowEncoderConfig,
    )

    assert hf_config.hidden_act == "gelu"
    image_shape = tuple(image_shape or hf_config.train_size)

    # adapter width: 64 hidden patch channels + 2-D fourier features with 64
    # bands (fixed inside HF PerceiverForOpticalFlow.__init__)
    kv_dim = 64 + 2 * (2 * 64 + 1)
    qk_ca, v_ca, qk_sa, v_sa = _encoder_channels(hf_config, kv_dim=kv_dim)

    encoder = OpticalFlowEncoderConfig(
        image_shape=image_shape,
        num_patch_input_channels=27,
        num_patch_hidden_channels=64,
        num_frequency_bands=64,
        num_cross_attention_layers=1,
        num_cross_attention_qk_channels=qk_ca,
        num_cross_attention_v_channels=v_ca,
        num_cross_attention_heads=hf_config.num_cross_attention_heads,
        num_self_attention_qk_channels=qk_sa,
        num_self_attention_v_channels=v_sa,
        num_self_attention_heads=hf_config.num_self_attention_heads,
        num_self_attention_layers_per_block=hf_config.num_self_attends_per_block,
        num_self_attention_blocks=hf_config.num_blocks,
        first_self_attention_block_shared=True,
        cross_attention_widening_factor=hf_config.cross_attention_widening_factor,
        self_attention_widening_factor=hf_config.self_attention_widening_factor,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
    )
    # HF flow decoder: qk = v = d_latents, 1 head, MLP widening 1
    # (PerceiverBasicDecoder defaults; d_latents = 512 for
    # deepmind/optical-flow-perceiver) — independent of the encoder config
    decoder = OpticalFlowDecoderConfig(
        image_shape=image_shape,
        num_cross_attention_qk_channels=hf_config.d_latents,
        num_cross_attention_v_channels=hf_config.d_latents,
        num_cross_attention_heads=1,
        cross_attention_widening_factor=1,
        cross_attention_residual=False,
        dropout=hf_config.attention_probs_dropout_prob,
        init_scale=hf_config.initializer_range,
        rescale_factor=100.0,
    )
    return OpticalFlowConfig(
        encoder=encoder,
        decoder=decoder,
        num_latents=hf_config.num_latents,
        num_latent_channels=hf_config.d_latents,
    )


def convert_optical_flow(hf_model, image_shape: Optional[tuple] = None, *, device: DeviceLike = "cuda",
                         dtype: Optional[torch.dtype] = None):
    """``transformers.PerceiverForOpticalFlow`` -> (config, the port's
    ``OpticalFlow`` on ``device``).

    Adds the patch-feature projection (HF ``conv_after_patches``) to the
    encoder mapping; the decoder queries are the adapted input (no learned
    output queries) (reference: vision/optical_flow/huggingface.py:186-203)."""
    config = convert_optical_flow_config(hf_model.config, image_shape)
    sd = dict(hf_model.state_dict())

    n_layers = config.encoder.num_self_attention_layers_per_block
    params = {
        "input_adapter": {
            "linear": _linear(sd, "perceiver.input_preprocessor.conv_after_patches")
        },
        "encoder": perceiver_encoder_params(sd, n_layers),
        "decoder": {
            "cross_attn": cross_attention_layer_params(
                sd, "perceiver.decoder.decoder.decoding_cross_attention"
            ),
            "output_adapter": {"linear": _linear(sd, "perceiver.decoder.decoder.final_layer")},
        },
    }
    from perceiver_io_tpu_torch.models.vision.optical_flow import OpticalFlow

    return _loaded(OpticalFlow, config, convert.optical_flow_state_dict_from_jax(params, decoder_residual=False),
                   device, dtype)
