"""The Perceiver IO image classifier's training options against the JAX
package at the small size of ``tests/test_torch_image.py`` (16x16x3 images,
8 bands, 128 latents x 32 channels, one cross-attention head, 2
self-attention heads, one layer per block and 2 weight-shared blocks, 4
classes; JAX weights carried across by ``convert``):

- the encoder's and the decoder's ``dropout`` on attention probabilities,
  masks drawn by numpy and fed to both packages (a test-local patch of
  ``flax.linen.Dropout.__call__``, keyed by the module's path and call, and
  of the port's ``keep_mask``; the shared self-attention block draws anew
  at each of its calls), plain and with activation checkpointing or
  offloading on both sides: logits, loss and the gradient tree;
- checkpointing and offloading in the port alone: the fused split-kv route
  is refused (as JAX's gate refuses it), and logits and gradients equal the
  plain forward's on the standard route bit for bit, with and without
  dropout drawn from a generator.

The JAX side runs without its fused kernels (its einsum attention on the
CPU): under dropout or remat its encoder takes the standard route, as the
port's does. Tolerances, those of ``tests/test_torch_image.py`` and
``tests/test_torch_image_train.py``: logits atol 1e-4, gradients per
parameter max abs difference over the JAX gradient's max abs value <= 4e-6
(the key-projection biases, whose gradient is 0 in exact arithmetic, dropout
or not, within 1e-10 of 0 on both sides), loss atol 4e-6."""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import perceiver_io_tpu_torch.core.modules as tmodules
from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.training.losses import _cross_entropy as jax_cross_entropy
from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax, jax_param_paths
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig
from perceiver_io_tpu_torch.training.losses import _cross_entropy

IMAGE = (16, 16, 3)
RATE = 0.1
LOGIT_ATOL, GRAD_RTOL, LOSS_ATOL = 1e-4, 4e-6, 4e-6
ZERO_GRAD_ATOL = 1e-10
REMAT = [{}, {"activation_checkpointing": True}, {"activation_offloading": True}]
REMAT_IDS = ["plain", "checkpointing", "offloading"]


def _configs(dropout=0.0, **top):
    enc = dict(image_shape=IMAGE, num_frequency_bands=8, num_cross_attention_heads=1, num_self_attention_heads=2,
               num_self_attention_layers_per_block=1, num_self_attention_blocks=2, dropout=dropout)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1, dropout=dropout)
    top = dict(num_latents=128, num_latent_channels=32, **top)
    return (JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc), decoder=JaxDecoderConfig(**dec), **top),
            ImageClassifierConfig(encoder=ImageEncoderConfig(**enc), decoder=ClassificationDecoderConfig(**dec),
                                  **top))


@pytest.fixture(scope="module")
def params():
    jm = JaxImageClassifier(_configs()[0])
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + IMAGE)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2,) + IMAGE).astype(np.float32), rng.integers(0, 4, size=2)


def _port(params, dropout=0.0, **top):
    tm = ImageClassifier(_configs(dropout, **top)[1], device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    return tm


def _jax_run(params, batch, dropout=0.0, **top):
    jm = JaxImageClassifier(_configs(dropout, **top)[0])
    x, y = jnp.asarray(batch[0]), jnp.asarray(batch[1])

    def loss_fn(p):
        logits = jm.apply(p, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_cross_entropy(logits, y)[0], logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), np.asarray(logits), image_classifier_state_dict_from_jax(jax.tree.map(np.asarray, grads))


def _port_run(tm, batch, generator=None, pad_mask=None):
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.from_numpy(batch[0]), pad_mask=pad_mask, deterministic=False, generator=generator)
    loss, _ = _cross_entropy(logits, torch.from_numpy(batch[1]))
    loss.backward()
    return loss.detach(), logits.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}


class _FedMasks:
    """Keep masks drawn by numpy, keyed by (Flax path, call index), served to
    both packages' attention-probability dropout."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = {}
        self.calls = collections.Counter()

    def get(self, path, shape):
        key = (path, self.calls[path])
        self.calls[path] += 1
        if key not in self.masks:
            self.masks[key] = self.rng.random(shape) < 1.0 - RATE
        assert self.masks[key].shape == tuple(shape), (key, shape)
        return self.masks[key]

    def patch(self, monkeypatch, tm):
        # an attention's Flax path: its q projection's, less the projection
        paths = {}
        for name, path in jax_param_paths(tm).items():
            if name.endswith(".q_proj.weight"):
                owner = tm.get_submodule(name[: -len(".q_proj.weight")])
                paths[id(owner)] = tuple(path.split("/")[1:-2]) + ("attn_dropout",)

        def jax_call(mod, inputs, deterministic=None, rng=None):
            deterministic = nn.merge_param("deterministic", mod.deterministic, deterministic)
            if mod.rate == 0.0 or deterministic:
                return inputs
            keep = jnp.asarray(self.get(tuple(mod.scope.path), inputs.shape))
            return jax.lax.select(keep, inputs / (1.0 - mod.rate), jnp.zeros_like(inputs))

        def port_keep(owner, site, shape, rate, generator, device):
            return None if rate == 0.0 else torch.from_numpy(self.get(paths[id(owner)], shape))

        monkeypatch.setattr(nn.Dropout, "__call__", jax_call)
        monkeypatch.setattr(tmodules, "keep_mask", port_keep)


@contextlib.contextmanager
def _split_calls():
    calls = []
    orig = tmodules.CrossAttentionLayer.call_with_split_kv

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    tmodules.CrossAttentionLayer.call_with_split_kv = spy
    try:
        yield calls
    finally:
        tmodules.CrossAttentionLayer.call_with_split_kv = orig


@pytest.mark.parametrize("remat", REMAT, ids=REMAT_IDS)
def test_dropout_matches_jax(params, monkeypatch, remat):
    batch = _batch(1)
    tm = _port(params, RATE, **remat)
    fed = _FedMasks(2)
    fed.patch(monkeypatch, tm)
    want = _jax_run(params, batch, RATE, **remat)
    fed.calls.clear()
    with _split_calls() as calls:
        got = _port_run(tm, batch)
    assert calls == []  # dropout refuses the split route, as JAX's gate does
    # the encoder's CA, the shared SA layer at each of its 2 calls, the decoder's CA
    assert len(fed.masks) == 4
    loss, logits, grads = got
    assert abs(float(loss) - want[0]) < LOSS_ATOL
    np.testing.assert_allclose(logits.numpy(), want[1], atol=LOGIT_ATOL, rtol=0)
    for name, w in want[2].items():
        w, g = w.numpy(), grads[name].numpy()
        if name.endswith("attention.k_proj.bias"):
            assert np.abs(w).max() <= ZERO_GRAD_ATOL and np.abs(g).max() <= ZERO_GRAD_ATOL, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("remat", ["activation_checkpointing", "activation_offloading"])
@pytest.mark.parametrize("dropout", [0.0, RATE], ids=["no_dropout", "dropout"])
def test_remat_takes_the_standard_route_and_equals_it_bit_for_bit(params, remat, dropout):
    """Remat refuses the split route (the JAX package's ``nn.remat`` wraps
    ``__call__`` only); the standard route with and without it gives the
    same logits and gradients bit for bit (an all-False pad mask puts the
    plain model on that route too)."""
    batch = _batch(3)
    pad = torch.zeros((2, IMAGE[0] * IMAGE[1]), dtype=torch.bool)
    with _split_calls() as calls:
        plain = _port_run(_port(params, dropout), batch, torch.Generator().manual_seed(4), pad)
        got = _port_run(_port(params, dropout, **{remat: True}), batch, torch.Generator().manual_seed(4), pad)
        _port_run(_port(params, dropout, **{remat: True}), batch, torch.Generator().manual_seed(4))
    assert calls == []
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    for name, g in plain[2].items():
        assert torch.equal(got[2][name], g), name
