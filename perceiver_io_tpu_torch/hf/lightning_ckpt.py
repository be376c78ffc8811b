"""Reference training-checkpoint importer: PyTorch Lightning ``.ckpt`` ->
the port's models (counterpart of ``perceiver_io_tpu/hf/lightning_ckpt.py``).

The reference publishes its trained models as Lightning checkpoints whose
``state_dict`` holds the backend module under a ``model.`` prefix
(reference: perceiver/model/core/lightning.py:12-28 ``save_hyperparameters`` +
``self.model``; perceiver/model/text/clm/huggingface.py:35-45
``from_checkpoint``; the published checkpoint list is
examples/convert.py:38-66). The importers map those parameter names onto
the JAX package's parameter tree (the numpy mapping below is a copy of the
JAX module's) and hand the tree to the port's ``convert.*_state_dict_from_jax``
converters, so the port restates no parameter name that ``convert.py``
holds. Each returns ``(config, state_dict)``: the port's config dataclass
and a ``state_dict`` that ``auto_model_for_config(config)`` loads with
``strict=True``. The reverse export writes a model trained here as a
reference-loadable checkpoint.

Reference naming scheme (perceiver/model/core/modules.py + adapter.py +
utils.py ``Residual``), which the port's own parameter names follow:

- ``MultiHeadAttention``: ``{q,k,v,o}_proj.weight`` (+ optional ``.bias``).
- ``MLP`` (nn.Sequential): ``0`` LayerNorm, ``1`` dense1, ``3`` dense2.
- attention layers (nn.Sequential of [attn, mlp], each usually inside a
  ``Residual`` with attribute ``module``): ``<layer>.0.module.<attn>``,
  ``<layer>.1.module.<mlp>``; with ``attention_residual=False`` the
  attention part is unwrapped (``<layer>.0.<attn>``).
- ``PerceiverIO`` models are nn.Sequential(encoder, decoder) -> prefixes
  ``0.`` and ``1.``; ``PerceiverAR`` models use attribute names
  (``input_adapter`` / ``cross_attention`` / ``self_attention`` / ``out_norm``
  / ``output_adapter``).
- non-learnable buffers (``frq_pos_encoding.inv_freq``, Fourier
  ``position_encoding``) are recomputed and ignored on import.

Checkpoints may carry ``hyper_parameters`` pickled with reference-package
dataclasses that are not importable here; ``load_lightning_checkpoint`` falls
back to a lenient unpickler that reconstructs unknown classes as attribute
stubs, so configs survive without the reference installed. Unconsumed
parameters raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from perceiver_io_tpu_torch import convert

_BUFFER_SUFFIXES = (".inv_freq", ".position_encoding")


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


class _TrackingDict(dict):
    """State-dict wrapper recording which keys a mapping consumed, so the
    importers can fail loudly on naming drift (unconsumed parameters)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.accessed = set()

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)


def _check_all_consumed(sd: _TrackingDict) -> None:
    leftover = [
        k for k in sd if k not in sd.accessed and not k.endswith(_BUFFER_SUFFIXES)
    ]
    if leftover:
        raise ValueError(
            f"{len(leftover)} checkpoint parameters were not mapped (naming "
            f"drift or unsupported architecture variant): {sorted(leftover)[:8]}..."
        )


def _has_prefix(sd: Dict[str, Any], prefix: str) -> bool:
    return any(k.startswith(prefix) for k in sd)


def _linear(sd, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _attention(sd, prefix: str) -> Dict[str, Any]:
    return {name: _linear(sd, f"{prefix}.{name}") for name in ("q_proj", "k_proj", "v_proj", "o_proj")}


def _mlp(sd, prefix: str) -> Dict[str, Any]:
    return {
        "LayerNorm_0": _layernorm(sd, f"{prefix}.0"),
        "dense_1": _linear(sd, f"{prefix}.1"),
        "dense_2": _linear(sd, f"{prefix}.3"),
    }


def _cross_attention_layer(sd, prefix: str) -> Dict[str, Any]:
    # attention sits inside a Residual (attribute `module`) unless the layer
    # was built with attention_residual=False (reference: modules.py:322-331)
    a = f"{prefix}.0.module" if _has_prefix(sd, f"{prefix}.0.module.") else f"{prefix}.0"
    return {
        "cross_attn": {
            "q_norm": _layernorm(sd, f"{a}.q_norm"),
            "kv_norm": _layernorm(sd, f"{a}.kv_norm"),
            "attention": _attention(sd, f"{a}.attention"),
        },
        "mlp": _mlp(sd, f"{prefix}.1.module"),
    }


def _self_attention_layer(sd, prefix: str) -> Dict[str, Any]:
    return {
        "self_attn": {
            "norm": _layernorm(sd, f"{prefix}.0.module.norm"),
            "attention": _attention(sd, f"{prefix}.0.module.attention"),
        },
        "mlp": _mlp(sd, f"{prefix}.1.module"),
    }


def _num_block_layers(sd, prefix: str) -> int:
    n = 0
    while _has_prefix(sd, f"{prefix}.{n}."):
        n += 1
    if n == 0:
        raise ValueError(f"no self-attention layers found under '{prefix}.'")
    return n


def _self_attention_block(sd, prefix: str) -> Dict[str, Any]:
    return {
        f"layer_{i}": _self_attention_layer(sd, f"{prefix}.{i}")
        for i in range(_num_block_layers(sd, prefix))
    }


def strip_lightning_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Backend parameter names from a Lightning ``state_dict``: keeps the
    ``model.``-prefixed entries (the wrapped backend), drops wrapper-level
    entries (loss buffers, metrics) and fairscale checkpoint-wrapper path
    segments."""
    out = {}
    for k, v in state_dict.items():
        if not k.startswith("model."):
            continue
        out[k[len("model."):].replace("._checkpoint_wrapped_module", "")] = v
    return out


def _backend_state_dict(ckpt_or_sd: Dict[str, Any]) -> _TrackingDict:
    sd = ckpt_or_sd.get("state_dict", ckpt_or_sd)
    if any(k.startswith("model.") for k in sd):
        sd = strip_lightning_prefix(sd)
    return _TrackingDict(sd)


def _plain(obj) -> Dict[str, Any]:
    """Hyper-parameter entry → plain dict (handles dicts, dataclasses, and
    the lenient-unpickler stubs)."""
    if obj is None:
        return {}
    if isinstance(obj, dict):
        return dict(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if hasattr(obj, "__dict__"):
        return dict(vars(obj))
    raise TypeError(f"cannot interpret hyper-parameter value {obj!r}")


def _create(cls, **kwargs):
    """``cls`` from the keyword arguments it has fields for (the JAX config
    classes' ``create``; reference: perceiver/model/core/config.py create)."""
    return cls(**{f.name: kwargs[f.name] for f in dataclasses.fields(cls) if f.name in kwargs})


def _hparams(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    for key in ("hyper_parameters", "hparams"):
        if key in ckpt:
            return _plain(ckpt[key])
    return {}


# -------------------------------------------------------------------------------------------
# Checkpoint loading (works without the reference package installed)
# -------------------------------------------------------------------------------------------


def load_lightning_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` with a fallback lenient unpickler: ``hyper_parameters``
    pickled as reference-package dataclasses reconstruct as attribute stubs
    instead of failing on the missing import."""
    import pickle

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # the weights-only loader refuses non-allowlisted globals (the
        # reference's pickled config dataclasses); only that failure opts
        # into the lenient path — truncated/corrupted files still raise
        pass

    stub_cache: Dict[Tuple[str, str], type] = {}

    def stub_class(module: str, name: str) -> type:
        key = (module, name)
        if key not in stub_cache:
            stub_cache[key] = type(name, (), {"__module__": module})
        return stub_cache[key]

    class _LenientUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return stub_class(module, name)

    class _pickle_module:
        Unpickler = _LenientUnpickler
        load = pickle.load
        loads = pickle.loads

    return torch.load(path, map_location="cpu", pickle_module=_pickle_module, weights_only=False)


def _load(ckpt_or_path) -> Dict[str, Any]:
    if isinstance(ckpt_or_path, (str,)) or hasattr(ckpt_or_path, "__fspath__"):
        return load_lightning_checkpoint(ckpt_or_path)
    return ckpt_or_path


# -------------------------------------------------------------------------------------------
# Causal sequence models (CLM, symbolic audio)
# -------------------------------------------------------------------------------------------


def causal_sequence_model_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Reference ``CausalSequenceModel`` state_dict → the JAX package's
    parameter tree (reference module structure:
    perceiver/model/core/modules.py:874-930)."""
    sd = _TrackingDict(sd) if not isinstance(sd, _TrackingDict) else sd
    params: Dict[str, Any] = {
        "input_adapter": {
            "txt_embedding": {"embedding": _np(sd["input_adapter.txt_embedding.weight"])}
        },
        "perceiver_ar": {
            "cross_attention": _cross_attention_layer(sd, "cross_attention"),
            "self_attention": _self_attention_block(sd, "self_attention"),
        },
    }
    if "input_adapter.pos_embedding.weight" in sd:
        params["input_adapter"]["pos_embedding"] = {
            "embedding": _np(sd["input_adapter.pos_embedding.weight"])
        }
    if "out_norm.weight" in sd:
        params["out_norm"] = _layernorm(sd, "out_norm")
    if "output_adapter.bias" in sd:
        params["output_adapter"] = {"bias": _np(sd["output_adapter.bias"])}
    _check_all_consumed(sd)
    return params


def _causal_config(ckpt, sd, config_cls):
    """Flat reference hparams (+ shape-derived facts) → the port's config dataclass.
    The reference CLM Lightning wrapper stores the backend config fields flat
    (``cls(**asdict(config))``, reference: text/clm/lightning.py:29-31)."""
    hp = {k: v for k, v in _hparams(ckpt).items() if v is None or isinstance(v, (int, float, bool, str))}
    vocab_size, num_channels = sd["input_adapter.txt_embedding.weight"].shape
    hp.update(
        vocab_size=int(vocab_size),
        num_channels=int(num_channels),
        num_self_attention_layers=_num_block_layers(sd, "self_attention"),
        abs_pos_emb="input_adapter.pos_embedding.weight" in sd,
        output_norm="out_norm.weight" in sd,
        output_bias="output_adapter.bias" in sd,
    )
    if "input_adapter.pos_embedding.weight" in sd:
        hp["max_seq_len"] = int(sd["input_adapter.pos_embedding.weight"].shape[0])
    # dense1 torch weight is (widening*c, c)
    ca1 = sd["cross_attention.1.module.1.weight"]
    hp["cross_attention_widening_factor"] = int(ca1.shape[0] // ca1.shape[1])
    sa1 = sd["self_attention.0.1.module.1.weight"]
    hp["self_attention_widening_factor"] = int(sa1.shape[0] // sa1.shape[1])
    return _create(config_cls, **hp)


def import_clm_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference ``LitCausalLanguageModel`` checkpoint → (the port's
    ``CausalLanguageModelConfig``, ``state_dict``)
    (reference: text/clm/huggingface.py:35-45)."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModelConfig

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)
    config = _causal_config(ckpt, sd, CausalLanguageModelConfig)
    return config, convert.state_dict_from_jax(causal_sequence_model_params(sd))


def import_symbolic_audio_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference ``LitSymbolicAudioModel`` checkpoint → (the port's
    ``SymbolicAudioModelConfig``, ``state_dict``)
    (reference: audio/symbolic/huggingface.py conversion seam)."""
    from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModelConfig

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)
    config = _causal_config(ckpt, sd, SymbolicAudioModelConfig)
    return config, convert.symbolic_audio_state_dict_from_jax(causal_sequence_model_params(sd))


# -------------------------------------------------------------------------------------------
# Perceiver IO models (MLM, text classifier, image classifier)
# -------------------------------------------------------------------------------------------


def _encoder_params(sd, prefix: str = "0") -> Dict[str, Any]:
    """Reference ``PerceiverEncoder`` → the JAX package's encoder subtree, including the
    repeated cross-attention variants (``cross_attn_n`` / ``self_attn_n``,
    reference: modules.py:565-571)."""
    enc = {
        "latent_provider": {"query": _np(sd[f"{prefix}.latent_provider._query"])},
        "cross_attn_1": _cross_attention_layer(sd, f"{prefix}.cross_attn_1"),
        "self_attn_1": _self_attention_block(sd, f"{prefix}.self_attn_1"),
    }
    if _has_prefix(sd, f"{prefix}.cross_attn_n."):
        enc["cross_attn_n"] = _cross_attention_layer(sd, f"{prefix}.cross_attn_n")
    if _has_prefix(sd, f"{prefix}.self_attn_n."):
        enc["self_attn_n"] = _self_attention_block(sd, f"{prefix}.self_attn_n")
    return enc


def _token_input_adapter_params(sd, prefix: str) -> Dict[str, Any]:
    adapter = {"txt_embedding": {"embedding": _np(sd[f"{prefix}.txt_embedding.weight"])}}
    if f"{prefix}.pos_embedding.weight" in sd:
        adapter["pos_embedding"] = {"embedding": _np(sd[f"{prefix}.pos_embedding.weight"])}
    return adapter


def _encoder_config_from(ckpt, sd, config_cls, **overrides):
    hp_enc = _plain(_hparams(ckpt).get("encoder"))
    vocab_size, num_input_channels = sd["0.input_adapter.txt_embedding.weight"].shape
    hp_enc.update(
        vocab_size=int(vocab_size),
        num_input_channels=int(num_input_channels),
        max_seq_len=int(sd["0.input_adapter.pos_embedding.weight"].shape[0]),
        num_self_attention_layers_per_block=_num_block_layers(sd, "0.self_attn_1"),
        **overrides,
    )
    hp_enc.pop("params", None)  # warm-start pointer, not an architecture field
    return _create(config_cls, **hp_enc)


def _decoder_residual(sd, prefix: str = "1") -> bool:
    """Whether the decoder's cross-attention sits in a Residual (the JAX tree
    does not say; the port's names do)."""
    return _has_prefix(sd, f"{prefix}.cross_attn.0.module.")


def import_mlm_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference ``LitMaskedLanguageModel`` checkpoint → (the port's
    ``MaskedLanguageModelConfig``, ``state_dict``), covering both the
    tied-embedding and independent output-adapter variants
    (reference: text/mlm/backend.py:37-89)."""
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
    from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModelConfig, TextDecoderConfig

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)
    hp = _hparams(ckpt)

    params: Dict[str, Any] = {
        "input_adapter": _token_input_adapter_params(sd, "0.input_adapter"),
        "encoder": _encoder_params(sd),
        "decoder": {
            "cross_attn": _cross_attention_layer(sd, "1.cross_attn"),
            "output_query_provider": {"query": _np(sd["1.output_query_provider._query"])},
        },
    }
    untied = "1.output_adapter.linear.weight" in sd
    if untied:
        # the output adapter is bound on the model itself (shared into the
        # decoder), so its params live at the top level (models/text/mlm.py:69)
        params["output_adapter"] = {"linear": _linear(sd, "1.output_adapter.linear")}
    elif "1.output_adapter.bias" in sd:
        params["output_adapter"] = {"bias": _np(sd["1.output_adapter.bias"])}
    _check_all_consumed(sd)

    hp_dec = _plain(hp.get("decoder"))
    hp_dec.update(
        vocab_size=int(sd["0.input_adapter.txt_embedding.weight"].shape[0]),
        max_seq_len=int(sd["1.output_query_provider._query"].shape[0]),
        num_output_query_channels=(
            int(sd["1.output_query_provider._query"].shape[1]) if untied else None
        ),
    )
    config = MaskedLanguageModelConfig(
        encoder=_encoder_config_from(ckpt, sd, TextEncoderConfig),
        decoder=_create(TextDecoderConfig, **hp_dec),
        num_latents=int(sd["0.latent_provider._query"].shape[0]),
        num_latent_channels=int(sd["0.latent_provider._query"].shape[1]),
    )
    return config, convert.mlm_state_dict_from_jax(params, decoder_residual=_decoder_residual(sd))


def import_text_classifier_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference ``LitTextClassifier`` checkpoint → (the port's
    ``TextClassifierConfig``, ``state_dict``)
    (reference: text/classifier/backend.py:15-46, huggingface.py:89-121)."""
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.text.classifier import TextClassifierConfig
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)

    params = {
        "input_adapter": _token_input_adapter_params(sd, "0.input_adapter"),
        "encoder": _encoder_params(sd),
        "decoder": _classification_decoder_params(sd),
    }
    _check_all_consumed(sd)

    config = TextClassifierConfig(
        encoder=_encoder_config_from(ckpt, sd, TextEncoderConfig),
        decoder=_classification_decoder_config(ckpt, sd, ClassificationDecoderConfig),
        num_latents=int(sd["0.latent_provider._query"].shape[0]),
        num_latent_channels=int(sd["0.latent_provider._query"].shape[1]),
    )
    return config, convert.text_classifier_state_dict_from_jax(params, decoder_residual=_decoder_residual(sd))


def _linear_head_decoder_params(sd, prefix: str = "1") -> Dict[str, Any]:
    """Reference ``PerceiverDecoder`` with a linear output adapter → the JAX
    package's decoder subtree (shared by the classifier task models, prefix ``1``,
    and the root-app time-series model, prefix ``decoder``)."""
    return {
        "cross_attn": _cross_attention_layer(sd, f"{prefix}.cross_attn"),
        "output_query_provider": {"query": _np(sd[f"{prefix}.output_query_provider._query"])},
        "output_adapter": {"linear": _linear(sd, f"{prefix}.output_adapter.linear")},
    }


# task-model call sites read as "the classification decoder"
_classification_decoder_params = _linear_head_decoder_params


def _classification_decoder_config(ckpt, sd, config_cls):
    hp_dec = _plain(_hparams(ckpt).get("decoder"))
    hp_dec.update(
        num_classes=int(sd["1.output_adapter.linear.weight"].shape[0]),
        num_output_query_channels=int(sd["1.output_query_provider._query"].shape[1]),
        num_output_queries=int(sd["1.output_query_provider._query"].shape[0]),
    )
    return _create(config_cls, **hp_dec)


def import_image_classifier_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference ``LitImageClassifier`` checkpoint → (the port's
    ``ImageClassifierConfig``, ``state_dict``). The image input adapter has no
    learnable parameters (Fourier features are recomputed)
    (reference: vision/image_classifier/backend.py:30-49)."""
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision.image_classifier import (
        ImageClassifierConfig,
        ImageEncoderConfig,
    )

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)
    hp = _hparams(ckpt)

    params = {
        "encoder": _encoder_params(sd),
        "decoder": _classification_decoder_params(sd),
    }
    _check_all_consumed(sd)

    hp_enc = _plain(hp.get("encoder"))
    hp_enc["num_self_attention_layers_per_block"] = _num_block_layers(sd, "0.self_attn_1")
    if "image_shape" in hp_enc and hp_enc["image_shape"] is not None:
        hp_enc["image_shape"] = tuple(hp_enc["image_shape"])
    config = ImageClassifierConfig(
        encoder=_create(ImageEncoderConfig, **hp_enc),
        decoder=_classification_decoder_config(ckpt, sd, ClassificationDecoderConfig),
        num_latents=int(sd["0.latent_provider._query"].shape[0]),
        num_latent_channels=int(sd["0.latent_provider._query"].shape[1]),
    )
    return config, convert.image_classifier_state_dict_from_jax(params)


def import_timeseries_checkpoint(ckpt_or_path) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Reference root-app ``MultivariatePerceiver`` checkpoint → (the port's
    ``TimeSeriesPerceiverConfig``, ``state_dict``). Unlike the task-package
    models the root app's LightningModule holds ``encoder``/``decoder``
    directly (no ``model.`` wrapper prefix) and flat hyper-parameters
    (reference: model.py:47-75)."""
    from perceiver_io_tpu_torch.models.timeseries import (
        TimeSeriesDecoderConfig,
        TimeSeriesEncoderConfig,
        TimeSeriesPerceiverConfig,
    )

    ckpt = _load(ckpt_or_path)
    sd = _backend_state_dict(ckpt)
    hp = _hparams(ckpt)

    pos_proj_w = _np(sd["encoder.input_adapter.pos_proj.weight"])  # (lat, 1+2*bands)
    params = {
        "input_adapter": {
            "linear": _linear(sd, "encoder.input_adapter.linear"),
            "pos_proj": {"kernel": pos_proj_w.T},  # bias-free (model.py:20)
        },
        "encoder": _encoder_params(sd, prefix="encoder"),
        "decoder": _linear_head_decoder_params(sd, prefix="decoder"),
    }
    _check_all_consumed(sd)

    heads_ca = int(hp.get("num_cross_attention_heads", 1))
    config = TimeSeriesPerceiverConfig(
        encoder=_create(
            TimeSeriesEncoderConfig,
            num_input_channels=int(sd["encoder.input_adapter.linear.weight"].shape[1]),
            in_len=int(hp["in_len"]),
            num_frequency_bands=(int(pos_proj_w.shape[1]) - 1) // 2,
            num_cross_attention_heads=heads_ca,
            num_self_attention_heads=int(hp.get("num_self_attention_heads", 1)),
            num_self_attention_layers_per_block=_num_block_layers(sd, "encoder.self_attn_1"),
            num_self_attention_blocks=int(hp["num_layers"]),
        ),
        decoder=_create(
            TimeSeriesDecoderConfig,
            out_len=int(sd["decoder.output_query_provider._query"].shape[0]),
            num_output_channels=int(sd["decoder.output_adapter.linear.weight"].shape[0]),
            num_cross_attention_heads=heads_ca,
        ),
        num_latents=int(sd["encoder.latent_provider._query"].shape[0]),
        num_latent_channels=int(sd["encoder.latent_provider._query"].shape[1]),
    )
    return config, convert.timeseries_state_dict_from_jax(params)


# -------------------------------------------------------------------------------------------
# Export: a port model → a reference-loadable checkpoint (reverse seam)
# -------------------------------------------------------------------------------------------


def export_causal_sequence_model_state_dict(model_or_state_dict) -> Dict[str, np.ndarray]:
    """A port ``CausalSequenceModel`` (or its ``state_dict``) → the reference
    backend's parameter names with numpy values (wrap with
    ``torch.from_numpy`` and a ``model.`` prefix for a loadable Lightning
    ``state_dict``). The port's names are the reference's, so this is the
    ``state_dict`` on the host; the JAX package's counterpart renames its
    Flax tree to the same dict."""
    sd = model_or_state_dict.state_dict() if hasattr(model_or_state_dict, "state_dict") else model_or_state_dict
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def save_lightning_checkpoint(path: str, model_or_state_dict, config) -> None:
    """Write a reference-loadable Lightning checkpoint for a causal sequence
    model: ``model.``-prefixed torch ``state_dict`` + flat dataclass
    hyper-parameters (the reference's ``cls(**asdict(config))`` contract,
    reference: text/clm/lightning.py:29-31)."""
    sd = {
        f"model.{k}": torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_causal_sequence_model_state_dict(model_or_state_dict).items()
    }
    torch.save({"state_dict": sd, "hyper_parameters": dataclasses.asdict(config)}, path)
