"""Training the port's Perceiver IO image classifier against the JAX
package, at the size of ``tests/test_torch_image.py`` (16x16x3 images, 128
latents x 32 channels, 2 self-attention heads, 2 weight-shared one-layer
blocks, 4 classes), on the split route with 8 and 32 frequency bands and on
the 3-head (head dim 12) heads-major route; the JAX side under
``default_flash(True)`` (interpret-mode kernels, the fused split route):
the ``classification_loss_fn`` gradient tree from converted weights, and
3-step AdamW trajectories (clip 1.0, warmup-cosine, 2 microbatch chunks)
against JAX's ``make_train_step``.

Tolerances, about four times the largest measured difference or the
issue's bound where that is larger (f32):

- gradients: per parameter, max abs difference over the JAX gradient's max
  abs value <= 4e-6 (measured 1.0e-6); the key-projection biases, whose
  gradient is 0 in exact arithmetic, within 1e-10 of 0 on both sides;
- losses within 4e-6, parameters after three steps within atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import classification_loss_fn as jax_classification_loss_fn
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig

IMAGE = (16, 16, 3)
GRAD_RTOL, LOSS_ATOL, PARAM_ATOL = 4e-6, 4e-6, 1e-6
ZERO_GRAD_ATOL = 1e-10  # measured up to 1.2e-12 on gradients that are 0 in exact arithmetic
CASES = [(8, 1, None), (32, 1, None), (8, 3, 36)]


def _configs(bands, ca_heads, ca_qk):
    enc = dict(image_shape=IMAGE, num_frequency_bands=bands, num_cross_attention_heads=ca_heads,
               num_cross_attention_qk_channels=ca_qk, num_self_attention_heads=2,
               num_self_attention_layers_per_block=1, num_self_attention_blocks=2)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1)
    top = dict(num_latents=128, num_latent_channels=32)
    return (JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc), decoder=JaxDecoderConfig(**dec), **top),
            ImageClassifierConfig(encoder=ImageEncoderConfig(**enc), decoder=ClassificationDecoderConfig(**dec),
                                  **top))


def _images(b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b,) + IMAGE).astype(np.float32)


@pytest.fixture(scope="module", params=CASES, ids=["split40", "split136", "heads3_d12"])
def models(request):
    """(JAX model, its params as numpy, the port's model with them, the
    port's config)."""
    jcfg, tcfg = _configs(*request.param)
    jm = JaxImageClassifier(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(_images())))
    tm = ImageClassifier(tcfg, device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    return jm, params, tm, tcfg


def test_classification_gradient_tree_matches_jax(models):
    jm, params, tm, _ = models
    rng = np.random.default_rng(3)
    batch = {"image": _images(seed=3), "label": rng.integers(0, 4, size=2)}
    jloss_fn = jax_classification_loss_fn(jm.apply)
    with default_flash(True):
        (jloss, jmetrics), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = image_classifier_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm.zero_grad()
    loss, metrics = tt.classification_loss_fn()(tm, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    assert float(metrics["acc"]) == float(jmetrics["acc"])
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w, g = w.numpy(), grads[name].numpy()
        if name.endswith("attention.k_proj.bias"):
            # a key bias shifts every score of a row alike, and the softmax
            # ignores such a shift: the gradient is 0, up to rounding
            assert np.abs(w).max() <= ZERO_GRAD_ATOL and np.abs(g).max() <= ZERO_GRAD_ATOL, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)
    tm.zero_grad()


def test_three_step_trajectory_matches_jax(models):
    """Three AdamW steps (clip 1.0, a warmup-cosine schedule) in two
    microbatch chunks on fresh random batches, against JAX's
    ``make_train_step`` from the same weights."""
    jm, params, _, tcfg = models
    tm = ImageClassifier(tcfg, device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    schedule = (joptim.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1),
                tt.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1))
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(schedule[0], gradient_clip=1.0),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jax_classification_loss_fn(jm.apply), donate=False, microbatch=2)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(schedule[1], gradient_clip=1.0))
    tstep = tt.make_train_step(tt.classification_loss_fn(), microbatch=2)
    rng = np.random.default_rng(4)
    jl, tl = [], []
    for i in range(3):
        batch = {"image": _images(4, seed=10 + i), "label": rng.integers(0, 4, size=4)}
        with default_flash(True):
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmetrics = tstep(tstate, batch)
        jl.append(float(jmetrics["loss"]))
        tl.append(float(tmetrics["loss"]))
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    want = image_classifier_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    init = image_classifier_state_dict_from_jax(params)
    got = dict(tm.named_parameters())
    assert max(float(np.abs(want[n].numpy() - init[n].numpy()).max()) for n in want) > 1e-4
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)
