"""The train and eval steps in the form a CUDA graph needs, on the CPU
against the JAX package (micro CLM: 128 latents, 64 channels, 4 heads, 2
layers; batches of 256 tokens).

- The non-finite sentinel selects on the device: on the NaN step of a
  three-step trajectory the parameters, AdamW's moments and steps and the
  schedule count hold bit for bit, as the JAX step's ``jnp.where`` holds
  them; afterwards parameters, moments and counts agree with optax's.
- The schedules take a 0-d tensor count (the captured step evaluates them
  on the card, as optax evaluates a schedule on its traced count) and give
  what the int form and optax give.
- The optimizer keeps its count and learning rate in tensors that updates
  advance in place, and its three steps match optax.
- ``make_eval_step`` gives what the JAX package's ``make_eval_step`` gives,
  for the CLM and the image classifier.

Tolerances: parameters atol 1e-6 and losses atol 4e-6, as
tests/test_torch_train.py states them; moments within 1e-5 of each
moment's largest value (they carry the gradients' 4e-6 relative
difference, tests/test_torch_train.py); logits atol 1e-4, as
tests/test_torch_clm.py and tests/test_torch_image.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.loop import make_eval_step as jax_make_eval_step
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX = 128, 256, 128
PARAM_ATOL, LOSS_ATOL, MOMENT_RTOL, LOGIT_ATOL = 1e-6, 4e-6, 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    return jm, params


def _port_model(params):
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


def _batch(rng, b):
    t = rng.integers(0, 262, size=(b, SEQ + 1))
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
            "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, b, SEQ - LATENTS, 0.5)}


def _jax_batch(batch):
    return {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}


def _poisoned(base):
    def loss_fn(*args):
        loss, _ = base(*args)
        loss = loss * args[1]["poison"]
        return loss, {"loss": loss}
    return loss_fn


def _optax_states(opt_state, kind):
    """Every ``kind`` state inside an optax chain's state."""
    if isinstance(opt_state, kind):
        return [opt_state]
    if isinstance(opt_state, tuple):
        return [s for part in opt_state for s in _optax_states(part, kind)]
    return []


def _port_moments(model, opt):
    named = dict(model.named_parameters())
    return ({n: opt.adamw.state[p]["exp_avg"] for n, p in named.items()},
            {n: opt.adamw.state[p]["exp_avg_sq"] for n, p in named.items()})


def test_sentinel_select_holds_parameters_moments_and_count_like_jax(models):
    jm, params = models
    schedule = (joptim.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1),
                tt.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1))
    rng = np.random.default_rng(3)
    batches = [dict(_batch(rng, 2), poison=np.float32(p)) for p in (1.0, np.nan, 1.0)]
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(schedule[0], gradient_clip=1.0),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(_poisoned(jax_clm_loss_fn(jm.apply, max_latents=LATENTS)), donate=False,
                                sentinel=True)
    tm = _port_model(params)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(schedule[1], gradient_clip=1.0))
    tstep = tt.make_train_step(_poisoned(tt.clm_loss_fn(LATENTS)), sentinel=True)
    opt = tstate.optimizer
    count, lr = opt.count, opt.lr
    held, skipped, jcounts, losses = [], [], [], []
    for batch in batches:
        jstate, jmetrics = jstep(jstate, _jax_batch(batch))
        tstate, tmetrics = tstep(tstate, batch)
        skipped.append((float(tmetrics["sentinel_skipped"]), float(jmetrics["sentinel_skipped"])))
        losses.append((float(tmetrics["loss"]), float(jmetrics["loss"])))
        held.append([t.clone() for t in opt.state_tensors()])
        jcounts.append([int(s.count) for s in _optax_states(jstate.opt_state, optax.ScaleByAdamState)
                        + _optax_states(jstate.opt_state, optax.ScaleByScheduleState)])
    assert skipped == [(0.0, 0.0), (1.0, 1.0), (0.0, 0.0)]
    np.testing.assert_allclose(*zip(*(losses[0], losses[2])), atol=LOSS_ATOL, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(held[1], held[0]))  # the NaN step held everything
    assert opt.count is count and opt.lr is lr and int(count) == 2 and tstate.step == 3
    assert jcounts == [[1, 1], [1, 1], [2, 2]]
    for name, w in state_dict_from_jax(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(dict(tm.named_parameters())[name].detach().numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    (adam,) = _optax_states(jstate.opt_state, optax.ScaleByAdamState)
    for port, want in zip(_port_moments(tm, opt), (adam.mu, adam.nu)):
        for name, w in state_dict_from_jax(jax.tree.map(np.asarray, want)).items():
            w = w.numpy()
            err = np.abs(port[name].numpy() - w).max()
            assert err <= MOMENT_RTOL * max(np.abs(w).max(), 1e-30), (name, err)


@pytest.mark.parametrize("pair", [
    (2e-3, tt.cosine_with_warmup(2e-3, 100, 10, min_fraction=0.1),
     joptim.cosine_with_warmup(2e-3, 100, 10, min_fraction=0.1)),
    (1e-3, tt.cosine_with_warmup(1e-3, 6, 1), joptim.cosine_with_warmup(1e-3, 6, 1)),
    (1e-3, tt.constant_with_warmup(1e-3, 4), joptim.constant_with_warmup(1e-3, 4)),
], ids=["cosine_min_fraction", "cosine", "constant"])
def test_schedules_take_a_tensor_count(pair):
    """The tensor form equals the int form exactly (the same f64
    operations); optax's within 1e-6 relative, or 1e-6 of the base rate
    where optax's f32 cosine cancels near the end of the decay."""
    base_lr, got, want = pair
    for step in (0, 1, 3, 4, 5, 10, 55, 100, 130):
        value = got(torch.tensor(step))
        assert isinstance(value, torch.Tensor) and value.dtype == torch.float64 and value.shape == ()
        assert float(value) == got(step)
        assert float(value) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-6 * base_lr)


@pytest.mark.parametrize("schedule", [tt.cosine_with_warmup(5e-2, 4, 1), tt.constant_with_warmup(3e-2, 2)],
                         ids=["cosine", "constant"])
def test_optimizer_count_and_lr_advance_in_place_and_match_optax(schedule):
    """Three updates (no clip) against optax's adamw on the same gradients;
    the count and learning rate stay the same tensors, the learning rate of
    the last update is the schedule's at count 2."""
    rng = np.random.default_rng(7)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (6,))]
    tx = optax.adamw(lambda t: schedule(int(t)), weight_decay=0.05)
    jp = [jnp.asarray(a) for a in p0]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = tt.make_optimizer(schedule, weight_decay=0.05)(tp)
    count, lr = opt.count, opt.lr
    for _ in range(3):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in p0]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    assert opt.count is count and opt.lr is lr and int(count) == 3
    assert float(lr) == pytest.approx(schedule(2), rel=1e-7)
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_eval_step_matches_jax_on_the_clm(models):
    jm, params = models
    tm = _port_model(params)
    ids = np.random.default_rng(4).integers(0, 262, size=(2, SEQ))
    want = jax_make_eval_step(lambda p, b: jm.apply(p, b["input_ids"], prefix_len=PREFIX).logits)(
        params, {"input_ids": jnp.asarray(ids)})
    got = tt.make_eval_step(lambda m, b: m(torch.from_numpy(b["input_ids"]), prefix_len=PREFIX).logits)(
        tm, {"input_ids": ids})
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


def test_eval_step_matches_jax_on_the_image_classifier():
    from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
    from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
    from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
    from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
    from perceiver_io_tpu.ops.flash_attention import default_flash
    from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig

    enc = dict(image_shape=(16, 16, 3), num_frequency_bands=8, num_cross_attention_heads=1,
               num_self_attention_heads=2, num_self_attention_layers_per_block=1, num_self_attention_blocks=2)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1)
    top = dict(num_latents=128, num_latent_channels=32)
    jm = JaxImageClassifier(JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc),
                                                     decoder=JaxDecoderConfig(**dec), **top))
    images = np.random.default_rng(5).normal(size=(2, 16, 16, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(images)))
    tm = ImageClassifier(ImageClassifierConfig(encoder=ImageEncoderConfig(**enc),
                                               decoder=ClassificationDecoderConfig(**dec), **top), device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    with default_flash(True):  # the JAX side on its split-kv route, as tests/test_torch_image.py
        want = jax_make_eval_step(lambda p, b: jm.apply(p, b["image"]))(params, {"image": jnp.asarray(images)})
    got = tt.make_eval_step(lambda m, b: m(torch.from_numpy(b["image"])))(tm, {"image": images})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
