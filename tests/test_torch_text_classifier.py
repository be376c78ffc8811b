"""The port's text classifier against the JAX package's, at the micro width of
``tests/test_torch_mlm.py``'s encoder (2 heads of q/k 8, v 20 in the cross-
and self-attention: the heads-major route, as the language-perceiver
encoder's 32/160 take it) with ``docs/model-construction.md``'s decoder cut
to size: 2 classes, one query of 32 channels, one head (the packed route).
The JAX side runs under ``default_flash(True)``, jitted.

Covered: the logits with and without a right-padded pad mask; the
``classification_loss_fn`` gradient tree on token batches; one AdamW step
(clip 1.0) in two microbatch chunks against the one-chunk step; the weight
bridge and ``jax_param_paths``.

Tolerances (f32), at the levels of ``tests/test_torch_image.py`` and
``tests/test_torch_image_train.py``: logits atol 1e-4; losses within 4e-6;
gradients per parameter, max abs difference over the JAX gradient's max abs
value <= 4e-6 (key-projection biases within 1e-10 of 0 on both sides);
parameters after the two-chunk step within atol 1e-5 (1% of the step's lr) of
the one-chunk step's: Adam's first step moves an element by lr * g / (|g| +
1e-8), so an element whose gradient is within ~1e-7 of 0 turns the rounding
of the chunks' average into a few 1e-6 of movement (measured up to 3.1e-6
against JAX's step, in the position table and the latent array)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.models.text import TextClassifier as JaxTextClassifier
from perceiver_io_tpu.models.text import TextClassifierConfig as JaxTextClassifierConfig
from perceiver_io_tpu.models.text import TextEncoderConfig as JaxTextEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.training import classification_loss_fn as jax_classification_loss_fn
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import jax_param_paths, text_classifier_state_dict_from_jax
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.text import TextClassifier, TextClassifierConfig, TextEncoderConfig

LOGIT_ATOL, LOSS_ATOL, GRAD_RTOL, ZERO_GRAD_ATOL, PARAM_ATOL = 1e-4, 4e-6, 4e-6, 1e-10, 1e-5
ENCODER = dict(vocab_size=262, max_seq_len=48, num_input_channels=48, num_cross_attention_heads=2,
               num_cross_attention_qk_channels=16, num_cross_attention_v_channels=40, num_self_attention_heads=2,
               num_self_attention_qk_channels=16, num_self_attention_v_channels=40,
               num_self_attention_layers_per_block=2)
DECODER = dict(num_classes=2, num_output_query_channels=32, num_cross_attention_heads=1)
TOP = dict(num_latents=16, num_latent_channels=32)


def _ids(b=4, n=40, seed=0):
    return np.random.default_rng(seed).integers(0, 262, size=(b, n)).astype(np.int32)


def _pad(b=4, n=40):
    pad = np.zeros((b, n), bool)
    for row, length in enumerate((40, 29, 13, 40)[:b]):
        pad[row, length:] = True
    return pad


@pytest.fixture(scope="module")
def models():
    """(JAX model, its jitted apply, its params as numpy, the port's model
    with them)."""
    jm = JaxTextClassifier(JaxTextClassifierConfig(encoder=JaxTextEncoderConfig(**ENCODER),
                                                   decoder=JaxDecoderConfig(**DECODER), **TOP))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_ids())))
    tm = TextClassifier(_config(), device="cpu")
    tm.load_state_dict(text_classifier_state_dict_from_jax(params), strict=True)
    return jm, jax.jit(jm.apply), params, tm


def _config():
    return TextClassifierConfig(encoder=TextEncoderConfig(**ENCODER), decoder=ClassificationDecoderConfig(**DECODER),
                                **TOP)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "right_padded"])
def test_logits_match_jax(models, padded):
    _, apply, params, tm = models
    x, pad = _ids(seed=1), _pad() if padded else None
    with default_flash(True):
        want = np.asarray(apply(params, jnp.asarray(x), pad_mask=None if pad is None else jnp.asarray(pad)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pad_mask=None if pad is None else torch.from_numpy(pad)).numpy()
    assert got.shape == want.shape == (4, 2)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_weight_bridge(models):
    params, tm = models[2], models[3]
    sd = text_classifier_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert {"0.input_adapter.txt_embedding.weight", "1.output_query_provider._query",
            "1.output_adapter.linear.weight", "1.cross_attn.0.module.q_norm.weight"} <= set(sd)
    flat = {"params/" + "/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    for name, path in jax_param_paths(tm).items():
        assert flat[path].size == sd[name].numel(), (name, path)


def _batch(seed, b=4):
    return {"input_ids": _ids(b, seed=seed), "label": np.random.default_rng(seed).integers(0, 2, size=b),
            "pad_mask": _pad(b)}


def test_classification_gradient_tree_matches_jax(models):
    jm, _, params, tm = models
    batch = _batch(3)
    loss_fn = jax_classification_loss_fn(jm.apply, deterministic=True)
    with default_flash(True):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = text_classifier_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm.zero_grad()
    loss, metrics = tt.classification_loss_fn(deterministic=True)(tm, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    assert float(metrics["acc"]) == float(jmetrics["acc"])
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w, g = w.numpy(), grads[name].numpy()
        if name.endswith("attention.k_proj.bias"):
            assert np.abs(w).max() <= ZERO_GRAD_ATOL and np.abs(g).max() <= ZERO_GRAD_ATOL, name
            continue
        assert np.abs(g - w).max() / np.abs(w).max() <= GRAD_RTOL, name
    tm.zero_grad()


def test_microbatched_step_equals_one_chunk(models):
    """``uniform_weighting = True``: one AdamW step (clip 1.0) in two
    microbatch chunks moves the weights as the one-chunk step does, and
    both move them."""
    params = models[2]
    moved = []
    for chunks in (1, 2):
        tm = TextClassifier(_config(), device="cpu")
        tm.load_state_dict(text_classifier_state_dict_from_jax(params), strict=True)
        state = tt.TrainState.create(tm, tt.make_optimizer(1e-3, gradient_clip=1.0))
        batch = {k: v for k, v in _batch(10).items() if k != "pad_mask"}
        step = tt.make_train_step(tt.classification_loss_fn(deterministic=True), microbatch=chunks)
        state, metrics = step(state, batch)
        moved.append((float(metrics["loss"]), {n: p.detach().clone() for n, p in tm.named_parameters()}))
    assert abs(moved[0][0] - moved[1][0]) < LOSS_ATOL
    init = text_classifier_state_dict_from_jax(params)
    assert max(float((moved[0][1][n] - init[n]).abs().max()) for n in init) > 1e-4
    for name, p in moved[0][1].items():
        torch.testing.assert_close(moved[1][1][name], p, atol=PARAM_ATOL, rtol=0, msg=name)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextClassifier(_config())
