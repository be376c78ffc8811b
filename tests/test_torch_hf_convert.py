"""The port's ``transformers`` converters (``hf.convert``) against Hugging
Face's Perceiver models and the JAX package's converters: small HF models
built locally from a seed (random init, no downloads), converted into the
port's models on the CPU.

Covered, for the masked LM (unpadded and right-padded), the Fourier image
classifier and optical flow: the converted config equals the JAX
converter's field for field; the port's ``state_dict`` equals the JAX
converter's tree taken through ``convert.*_state_dict_from_jax`` bit for bit,
and holds as many parameters as the HF model; the port's logits (flow) match
HF's within atol 1e-4 (the reference's conversion tolerance,
reference: tests/masked_language_model_convert_test.py). The
``deepmind/language-perceiver`` configuration, built by HF and converted on
the meta device, counts 201,108,230 parameters on both sides."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from perceiver_io_tpu.hf import convert_image_classifier as jax_convert_image_classifier
from perceiver_io_tpu.hf import convert_masked_language_model as jax_convert_masked_language_model
from perceiver_io_tpu.hf import convert_optical_flow as jax_convert_optical_flow
from perceiver_io_tpu_torch import convert
from perceiver_io_tpu_torch.hf import (
    convert_image_classifier,
    convert_masked_language_model,
    convert_mlm_config,
    convert_optical_flow,
)
from perceiver_io_tpu_torch.models.text import MaskedLanguageModel

transformers = pytest.importorskip("transformers")
from transformers import PerceiverConfig  # noqa: E402
from transformers.models.perceiver.modeling_perceiver import (  # noqa: E402
    PerceiverForImageClassificationFourier,
    PerceiverForMaskedLM,
    PerceiverForOpticalFlow,
)

ATOL = 1e-4
LANGUAGE_PERCEIVER_PARAMS = 201_108_230


def _hf(cls, seed, **config):
    torch.manual_seed(seed)
    model = cls(PerceiverConfig(attention_probs_dropout_prob=0.0, **config))
    return model.eval()


def _same(port_pair, jax_pair, to_port, hf_model):
    """The port's config equals JAX's field for field; its state_dict is the
    JAX tree through the port's converter, bit for bit, as many parameters
    as HF's."""
    (config, model), (jconfig, variables) = port_pair, jax_pair
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    want = to_port(jax.tree.map(np.asarray, variables))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert sum(p.numel() for p in model.parameters()) == sum(p.numel() for p in hf_model.parameters())


@pytest.fixture(scope="module")
def mlm():
    hf_model = _hf(PerceiverForMaskedLM, 0, num_latents=8, d_latents=32, d_model=24, num_blocks=1,
                   num_self_attends_per_block=2, num_self_attention_heads=4, num_cross_attention_heads=4,
                   vocab_size=262, max_position_embeddings=48, cross_attention_widening_factor=2,
                   self_attention_widening_factor=3)
    return hf_model, convert_masked_language_model(hf_model, device="cpu")


def test_masked_language_model_matches_hf_and_jax(mlm):
    hf_model, (config, model) = mlm
    _same((config, model), jax_convert_masked_language_model(hf_model),
          lambda p: convert.mlm_state_dict_from_jax(p, decoder_residual=False), hf_model)
    x = np.random.default_rng(0).integers(0, 262, size=(2, 48))
    with torch.no_grad():
        ref = hf_model(input_ids=torch.tensor(x)).logits.numpy()
        out = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_masked_language_model_right_padded_matches_hf(mlm):
    hf_model, (_, model) = mlm
    x = np.random.default_rng(1).integers(0, 262, size=(2, 32))
    attention_mask = np.ones((2, 32), dtype=np.int64)
    attention_mask[0, 28:] = 0
    with torch.no_grad():
        ref = hf_model(input_ids=torch.tensor(x), attention_mask=torch.tensor(attention_mask)).logits.numpy()
        out = model(torch.tensor(x), pad_mask=torch.tensor(attention_mask == 0)).numpy()
    np.testing.assert_allclose(out[1], ref[1, :32], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[0, :28], ref[0, :28], atol=ATOL, rtol=0)


def test_language_perceiver_count_on_the_meta_device():
    with torch.device("meta"):
        hf_model = PerceiverForMaskedLM(PerceiverConfig(qk_channels=256, v_channels=1280))
    assert sum(p.numel() for p in hf_model.parameters()) == LANGUAGE_PERCEIVER_PARAMS
    config = convert_mlm_config(hf_model.config)
    model = MaskedLanguageModel(config, device="meta")
    assert sum(p.numel() for p in model.parameters()) == LANGUAGE_PERCEIVER_PARAMS
    assert (config.num_latents, config.num_latent_channels) == (256, 1280)
    assert config.encoder.num_self_attention_layers_per_block == 26


def test_image_classifier_matches_hf_and_jax():
    hf_model = _hf(PerceiverForImageClassificationFourier, 1, num_latents=4, d_latents=16, num_blocks=1,
                   num_self_attends_per_block=2, num_self_attention_heads=2, num_cross_attention_heads=2,
                   qk_channels=16, v_channels=16, cross_attention_widening_factor=3, num_labels=3)
    config, model = convert_image_classifier(hf_model, device="cpu")
    _same((config, model), jax_convert_image_classifier(hf_model), convert.image_classifier_state_dict_from_jax,
          hf_model)
    img = np.random.default_rng(2).normal(size=(1, 3, 224, 224)).astype(np.float32)
    with torch.no_grad():
        ref = hf_model(inputs=torch.tensor(img)).logits.numpy()
        out = model(torch.tensor(img.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_optical_flow_matches_hf_and_jax():
    hf_model = _hf(PerceiverForOpticalFlow, 2, num_latents=4, d_latents=16, num_blocks=1,
                   num_self_attends_per_block=2, num_self_attention_heads=2, num_cross_attention_heads=2,
                   qk_channels=16, v_channels=16, cross_attention_widening_factor=2, train_size=[16, 24])
    config, model = convert_optical_flow(hf_model, device="cpu")
    _same((config, model), jax_convert_optical_flow(hf_model),
          lambda p: convert.optical_flow_state_dict_from_jax(p, decoder_residual=False), hf_model)
    patches = np.random.default_rng(3).normal(size=(1, 2, 27, 16, 24)).astype(np.float32)
    with torch.no_grad():
        ref = hf_model(inputs=torch.tensor(patches)).logits.numpy()
        out = model(torch.tensor(patches.transpose(0, 1, 3, 4, 2))).numpy()
    np.testing.assert_allclose(out, ref.reshape(out.shape), atol=ATOL, rtol=0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_converted_models_default_to_the_card(mlm):
    hf_model, _ = mlm
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        convert_masked_language_model(hf_model)
