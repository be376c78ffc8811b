"""The port's reference Lightning checkpoint import and export
(``hf.lightning_ckpt``) against the JAX package's.

Reference checkpoints are written here from seeded port models at micro
widths (the port's parameter names are the reference's): the causal LM and
the symbolic audio model (flat hyper-parameters), the masked LM with a tied
and with an independent head, the text and image classifiers (nested
``encoder``/``decoder`` hyper-parameters) and the time series (the root
application's flat hyper-parameters, no ``model.`` prefix). Each port
importer must give what the JAX importer followed by the port's
``convert.*_state_dict_from_jax`` gives, bit for bit, and the same config
field for field; the state_dict loads into ``auto_model_for_config(config)``
strictly and equals the checkpoint's. Unconsumed names raise in both; the
lenient unpickler stubs classes of a package that is not installed; the
CLM's export and import round trip, and the port's exported file holds the
JAX exporter's tensors. All comparisons are exact."""

import dataclasses
import sys
import types

import jax
import numpy as np
import pytest
import torch

from perceiver_io_tpu.hf import lightning_ckpt as jlc
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu_torch import convert
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.hf import auto_model_for_config
from perceiver_io_tpu_torch.hf import lightning_ckpt as tlc
from perceiver_io_tpu_torch.models.audio import SymbolicAudioModelConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModelConfig, MaskedLanguageModelConfig
from perceiver_io_tpu_torch.models.text import TextClassifierConfig, TextDecoderConfig, TextEncoderConfig
from perceiver_io_tpu_torch.models.timeseries import TimeSeriesDecoderConfig, TimeSeriesEncoderConfig
from perceiver_io_tpu_torch.models.timeseries import TimeSeriesPerceiverConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifierConfig, ImageEncoderConfig

CAUSAL = dict(max_seq_len=48, max_latents=8, num_channels=16, num_heads=2, num_self_attention_layers=2,
              cross_attention_widening_factor=2, self_attention_widening_factor=3)
ENCODER = dict(vocab_size=262, max_seq_len=24, num_input_channels=16, num_cross_attention_heads=2,
               num_self_attention_heads=2, num_self_attention_layers_per_block=2)
TOP = dict(num_latents=8, num_latent_channels=16)


def _text_encoder():
    return TextEncoderConfig(**ENCODER)


CASES = {
    # name: (config, port importer, JAX importer, JAX-tree -> port converter, hyper-parameters, model. prefix)
    "clm": (CausalLanguageModelConfig(vocab_size=262, **CAUSAL), tlc.import_clm_checkpoint,
            jlc.import_clm_checkpoint, convert.state_dict_from_jax, "flat", True),
    "sam": (SymbolicAudioModelConfig(**CAUSAL), tlc.import_symbolic_audio_checkpoint,
            jlc.import_symbolic_audio_checkpoint, convert.symbolic_audio_state_dict_from_jax, "flat", True),
    "mlm_tied": (MaskedLanguageModelConfig(encoder=_text_encoder(), decoder=TextDecoderConfig(
        vocab_size=262, max_seq_len=24, num_cross_attention_heads=2), **TOP), tlc.import_mlm_checkpoint,
        jlc.import_mlm_checkpoint, lambda p: convert.mlm_state_dict_from_jax(p), "nested", True),
    "mlm_untied": (MaskedLanguageModelConfig(encoder=_text_encoder(), decoder=TextDecoderConfig(
        vocab_size=262, max_seq_len=24, num_cross_attention_heads=2, num_output_query_channels=12,
        cross_attention_residual=False), **TOP), tlc.import_mlm_checkpoint, jlc.import_mlm_checkpoint,
        lambda p: convert.mlm_state_dict_from_jax(p, decoder_residual=False), "nested", True),
    "text_classifier": (TextClassifierConfig(encoder=_text_encoder(), decoder=ClassificationDecoderConfig(
        num_classes=3, num_output_query_channels=16, num_cross_attention_heads=1), **TOP),
        tlc.import_text_classifier_checkpoint, jlc.import_text_classifier_checkpoint,
        convert.text_classifier_state_dict_from_jax, "nested", True),
    "image_classifier": (ImageClassifierConfig(encoder=ImageEncoderConfig(
        image_shape=(8, 8, 3), num_frequency_bands=4, num_cross_attention_heads=1, num_self_attention_heads=2,
        num_self_attention_layers_per_block=2), decoder=ClassificationDecoderConfig(
        num_classes=4, num_output_query_channels=16, num_cross_attention_heads=1), **TOP),
        tlc.import_image_classifier_checkpoint, jlc.import_image_classifier_checkpoint,
        convert.image_classifier_state_dict_from_jax, "nested", True),
    "timeseries": (TimeSeriesPerceiverConfig(encoder=TimeSeriesEncoderConfig(
        num_input_channels=3, in_len=20, num_frequency_bands=4, num_cross_attention_heads=1,
        num_self_attention_heads=1, num_self_attention_layers_per_block=1, num_self_attention_blocks=2),
        decoder=TimeSeriesDecoderConfig(out_len=6, num_output_channels=3, num_cross_attention_heads=1), **TOP),
        tlc.import_timeseries_checkpoint, jlc.import_timeseries_checkpoint, convert.timeseries_state_dict_from_jax,
        "timeseries", False),
}


def _hparams(config, kind):
    if kind == "flat":
        return dataclasses.asdict(config)
    if kind == "nested":
        return {"encoder": dataclasses.asdict(config.encoder), "decoder": dataclasses.asdict(config.decoder),
                "num_latents": config.num_latents, "num_latent_channels": config.num_latent_channels}
    enc = config.encoder
    return {"in_len": enc.in_len, "num_layers": enc.num_self_attention_blocks,
            "num_cross_attention_heads": enc.num_cross_attention_heads,
            "num_self_attention_heads": enc.num_self_attention_heads}


def _checkpoint(name, seed=0):
    config, *_, kind, prefixed = CASES[name]
    model = auto_model_for_config(config, device="cpu", generator=torch.Generator().manual_seed(seed))
    sd = {("model." if prefixed else "") + k: v.clone() for k, v in model.state_dict().items()}
    if prefixed:
        sd["loss.weight"] = torch.ones(1)  # a wrapper-level entry the import drops
    return {"state_dict": sd, "hyper_parameters": _hparams(config, kind)}, model.state_dict()


@pytest.mark.parametrize("name", list(CASES))
def test_import_matches_jax_then_convert(name, tmp_path):
    config, port_import, jax_import, to_port, *_ = CASES[name]
    ckpt, weights = _checkpoint(name)
    path = str(tmp_path / f"{name}.ckpt")
    torch.save(ckpt, path)
    got_config, got = port_import(path)
    jconfig, variables = jax_import(path)
    want = to_port(jax.tree.map(np.asarray, variables))
    assert dataclasses.asdict(got_config) == dataclasses.asdict(jconfig)
    assert type(got_config).__name__ == type(jconfig).__name__ or name == "timeseries"
    assert sorted(got) == sorted(want) == sorted(weights)
    assert all(torch.equal(got[k], want[k]) and torch.equal(got[k], weights[k]) for k in want)
    model = auto_model_for_config(got_config, device="cpu")
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["clm", "image_classifier"])
def test_unconsumed_parameters_raise_in_both(name):
    _, port_import, jax_import, *_ = CASES[name]
    ckpt, _ = _checkpoint(name)
    ckpt["state_dict"]["model.mystery.weight"] = torch.zeros(2)
    for fn in (port_import, jax_import):
        with pytest.raises(ValueError, match="were not mapped"):
            fn(ckpt)


def test_lenient_unpickler_stubs_a_missing_package(tmp_path):
    mod_name = "perceiver_ref_fake.backend"
    mod = types.ModuleType(mod_name)

    class TextEncoderConfig:
        pass

    TextEncoderConfig.__module__ = mod_name
    TextEncoderConfig.__qualname__ = "TextEncoderConfig"
    mod.TextEncoderConfig = TextEncoderConfig
    sys.modules["perceiver_ref_fake"] = types.ModuleType("perceiver_ref_fake")
    sys.modules[mod_name] = mod
    try:
        cfg = TextEncoderConfig()
        cfg.vocab_size, cfg.num_input_channels = 262, 16
        path = tmp_path / "stub.ckpt"
        torch.save({"state_dict": {}, "hyper_parameters": {"encoder": cfg, "num_latents": 8}}, path)
    finally:
        del sys.modules[mod_name]
        del sys.modules["perceiver_ref_fake"]
    for load in (tlc.load_lightning_checkpoint, jlc.load_lightning_checkpoint):
        enc = load(str(path))["hyper_parameters"]["encoder"]
        assert (enc.vocab_size, enc.num_input_channels, type(enc).__name__) == (262, 16, "TextEncoderConfig")
    with open(tmp_path / "torn.ckpt", "wb") as f:
        f.write(path.read_bytes()[:100])
    with pytest.raises(Exception):
        tlc.load_lightning_checkpoint(str(tmp_path / "torn.ckpt"))


def test_clm_export_import_round_trip_matches_jax(tmp_path):
    config = CASES["clm"][0]
    model = auto_model_for_config(config, device="cpu", generator=torch.Generator().manual_seed(3))
    tlc.save_lightning_checkpoint(str(tmp_path / "port.ckpt"), model, config)
    back_config, back = tlc.import_clm_checkpoint(str(tmp_path / "port.ckpt"))
    assert back_config == config
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    # the JAX exporter's file from the same weights
    params = {"params": jlc.causal_sequence_model_params(
        {k: v.numpy() for k, v in model.state_dict().items()})}
    jlc.save_lightning_checkpoint(str(tmp_path / "jax.ckpt"), params, JaxCLMConfig(**dataclasses.asdict(config)))
    ours, theirs = (torch.load(tmp_path / n, weights_only=True) for n in ("port.ckpt", "jax.ckpt"))
    assert ours["hyper_parameters"] == theirs["hyper_parameters"]
    assert sorted(ours["state_dict"]) == sorted(theirs["state_dict"])
    assert all(torch.equal(ours["state_dict"][k], theirs["state_dict"][k]) for k in ours["state_dict"])
    exported = tlc.export_causal_sequence_model_state_dict(model.state_dict())
    assert all(np.array_equal(exported[k], v) for k, v in jlc.export_causal_sequence_model_state_dict(params).items())
