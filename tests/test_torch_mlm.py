"""The port's masked language model against the JAX package's, at a micro
width whose attention takes the routes of ``deepmind/language-perceiver``'s:
the encoder's cross- and self-attention have unequal heads outside the packed
layout (2 heads of q/k 8, v 20: the heads-major route, K8 on the card), the
decoder's cross-attention unequal heads inside it (2 heads of 8/24: the
packed route, K2), without an attention residual, over 48 output queries.
Vocabulary 262 (the byte tokenizer's), 48 input channels, 16 latents x 32
channels, 2 self-attention layers. The JAX side runs under
``default_flash(True)``; at these lengths (under 128) its gate takes its
einsum route.

Covered: the logits with and without a right-padded pad mask, for the tied
and the independent head; which kernel route each attention takes; the
``masked_lm_loss_fn`` gradient tree; ``make_train_step`` refusing
``microbatch=2`` for that loss in both packages; ``MaskFiller.fill``'s
strings and errors against JAX's; the weight bridge and ``jax_param_paths``;
the parameter count at the ``deepmind/language-perceiver`` configuration on
the meta device.

Tolerances (f32), at the levels of ``tests/test_torch_image.py`` and
``tests/test_torch_image_train.py``: logits atol 1e-4; the loss within 4e-6;
gradients per parameter, max abs difference over the JAX gradient's max abs
value <= 4e-6 (key-projection biases, 0 in exact arithmetic, within 1e-10
of 0 on both sides)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.text.tokenizer import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.hf.mask_filler import MaskFiller as JaxMaskFiller
from perceiver_io_tpu.models.text import MaskedLanguageModel as JaxMaskedLanguageModel
from perceiver_io_tpu.models.text import MaskedLanguageModelConfig as JaxMaskedLanguageModelConfig
from perceiver_io_tpu.models.text import TextDecoderConfig as JaxTextDecoderConfig
from perceiver_io_tpu.models.text import TextEncoderConfig as JaxTextEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.training import masked_lm_loss_fn as jax_masked_lm_loss_fn
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import jax_param_paths, mlm_state_dict_from_jax
from perceiver_io_tpu_torch.core import attention as tattention
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
from perceiver_io_tpu_torch.hf import MaskFiller
from perceiver_io_tpu_torch.models.text import MaskedLanguageModel, MaskedLanguageModelConfig, TextDecoderConfig
from perceiver_io_tpu_torch.models.text import TextEncoderConfig

SEQ = 48
LOGIT_ATOL, LOSS_ATOL, GRAD_RTOL, ZERO_GRAD_ATOL = 1e-4, 4e-6, 4e-6, 1e-10


def _configs(head_channels=None):
    enc = dict(vocab_size=262, max_seq_len=SEQ, num_input_channels=48, num_cross_attention_heads=2,
               num_cross_attention_qk_channels=16, num_cross_attention_v_channels=40, num_self_attention_heads=2,
               num_self_attention_qk_channels=16, num_self_attention_v_channels=40,
               num_self_attention_layers_per_block=2)
    dec = dict(vocab_size=262, max_seq_len=SEQ, num_output_query_channels=head_channels, num_cross_attention_heads=2,
               num_cross_attention_qk_channels=16, num_cross_attention_v_channels=48, cross_attention_residual=False)
    top = dict(num_latents=16, num_latent_channels=32)
    return (JaxMaskedLanguageModelConfig(encoder=JaxTextEncoderConfig(**enc), decoder=JaxTextDecoderConfig(**dec),
                                         **top),
            MaskedLanguageModelConfig(encoder=TextEncoderConfig(**enc), decoder=TextDecoderConfig(**dec), **top))


def _ids(b=3, n=40, seed=0):
    return np.random.default_rng(seed).integers(0, 262, size=(b, n)).astype(np.int32)


def _right_pad(b, n, lengths):
    pad = np.zeros((b, n), bool)
    for row, length in enumerate(lengths):
        pad[row, length:] = True
    return pad


class _Jitted:
    """The JAX model with a jitted ``apply`` (what ``MaskFiller`` reads:
    ``apply`` and ``config``): the same function, compiled once."""

    def __init__(self, model):
        self.config = model.config
        self.apply = jax.jit(model.apply)


@pytest.fixture(scope="module", params=[None, 32], ids=["tied", "independent"])
def models(request):
    """(JAX model with a jitted apply, its params as numpy, the port's model
    with them)."""
    jcfg, tcfg = _configs(request.param)
    jm = JaxMaskedLanguageModel(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_ids())))
    tm = MaskedLanguageModel(tcfg, device="cpu")
    tm.load_state_dict(mlm_state_dict_from_jax(params, decoder_residual=False), strict=True)
    return _Jitted(jm), params, tm


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "right_padded"])
def test_logits_match_jax(models, padded):
    jm, params, tm = models
    x = _ids(seed=1)
    pad = _right_pad(3, 40, (40, 31, 17)) if padded else None
    with default_flash(True):
        want = np.asarray(jm.apply(params, jnp.asarray(x), pad_mask=None if pad is None else jnp.asarray(pad)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pad_mask=None if pad is None else torch.from_numpy(pad)).numpy()
    assert got.shape == want.shape == (3, 40, 262)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_head_and_weight_bridge(models):
    """The tied model holds one bias beside the token table; the independent
    one a linear head of its own. Every port parameter comes from the JAX
    tree, and ``jax_param_paths`` names the JAX leaf of each."""
    _, params, tm = models
    sd = mlm_state_dict_from_jax(params, decoder_residual=False)
    assert set(sd) == set(tm.state_dict())
    assert {"0.input_adapter.txt_embedding.weight", "0.input_adapter.pos_embedding.weight",
            "1.output_query_provider._query", "1.cross_attn.0.q_norm.weight"} <= set(sd)
    assert ("1.output_adapter.bias" in sd) == tm.tied and ("1.output_adapter.linear.weight" in sd) != tm.tied
    flat = {"params/" + "/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    paths = jax_param_paths(tm)
    assert set(paths) == set(sd)
    for name, path in paths.items():
        assert flat[path].size == sd[name].numel(), (name, path)


@pytest.mark.parametrize("models", [None], ids=["tied"], indirect=True)
def test_routes(models, monkeypatch):
    """Per forward: the heads-major route for the encoder's cross-attention
    and its two self-attention layers (head dims 8/20), the packed route for
    the decoder's cross-attention (8/24)."""
    tm = models[2]
    calls = []
    for name in ("flash_attention", "flash_attention_packed"):
        fn = getattr(tattention, name)
        monkeypatch.setattr(tattention, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    with torch.no_grad():
        tm(torch.from_numpy(_ids()))
    assert calls == ["flash_attention"] * 3 + ["flash_attention_packed"]


def _mlm_batch(seed):
    rng = np.random.default_rng(seed)
    ids = _ids(seed=seed)
    labels = np.full(ids.shape, -100, np.int64)
    masked = rng.random(ids.shape) < 0.25
    labels[masked] = ids[masked]
    ids = np.where(masked, 3, ids).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "pad_mask": _right_pad(3, 40, (40, 33, 25))}


def test_masked_lm_gradient_tree_matches_jax(models):
    jm, params, tm = models
    batch = _mlm_batch(5)
    loss_fn = functools.partial(jax_masked_lm_loss_fn(jm.apply), deterministic=True)
    with default_flash(True):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = mlm_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), decoder_residual=False)
    tm.zero_grad()
    loss, metrics = tt.masked_lm_loss_fn(deterministic=True)(tm, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    assert int(metrics["num_masked"]) == int(jmetrics["num_masked"]) > 0
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w, g = w.numpy(), grads[name].numpy()
        if name.endswith("attention.k_proj.bias"):
            assert np.abs(w).max() <= ZERO_GRAD_ATOL and np.abs(g).max() <= ZERO_GRAD_ATOL, name
            continue
        assert np.abs(g - w).max() / np.abs(w).max() <= GRAD_RTOL, name
    tm.zero_grad()


@pytest.mark.parametrize("models", [None], ids=["tied"], indirect=True)
def test_train_step_refuses_microbatches_for_the_masked_lm_loss(models):
    """The loss normalizes by each call's masked count: both packages refuse
    to split its batches; one chunk takes a step."""
    jm, params, tm = models
    assert tt.masked_lm_loss_fn().uniform_weighting is False
    with pytest.raises(ValueError, match="uniform_weighting=False"):
        tt.make_train_step(tt.masked_lm_loss_fn(), microbatch=2)
    with pytest.raises(ValueError, match="uniform_weighting=False"):
        jax_make_train_step(jax_masked_lm_loss_fn(jm.apply), microbatch=2)
    model = MaskedLanguageModel(tm.config, device="cpu")
    model.load_state_dict(tm.state_dict())
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3))
    state, metrics = tt.make_train_step(tt.masked_lm_loss_fn())(state, _mlm_batch(6))
    assert bool(torch.isfinite(metrics["loss"])) and int(metrics["num_masked"]) > 0


SAMPLES = ["I have watched this [MASK] and it was awesome.", "[MASK][MASK] is a [MASK]", "short [MASK]"]


def test_mask_filler_matches_jax(models):
    jm, params, tm = models
    want = JaxMaskFiller(jm, params, JaxByteTokenizer()).fill(SAMPLES, num_predictions=3)
    got = MaskFiller(tm, ByteTokenizer(), device="cpu").fill(SAMPLES, num_predictions=3)
    assert got == want
    assert [len(fills) for fills in got] == [3, 3, 3]


@pytest.mark.parametrize("models", [None], ids=["tied"], indirect=True)
@pytest.mark.parametrize("sample,detail", [("no mask here", "the input contains none"),
                                           ("x" * SEQ + "[MASK]", "truncated out of the model's 48-token window")])
def test_mask_filler_errors_match_jax(models, sample, detail):
    jm, params, tm = models
    with pytest.raises(ValueError, match="Sample 1 has no") as want:
        JaxMaskFiller(jm, params, JaxByteTokenizer()).fill(["a [MASK]", sample])
    with pytest.raises(ValueError, match="Sample 1 has no") as got:
        MaskFiller(tm, ByteTokenizer(), device="cpu").fill(["a [MASK]", sample])
    assert str(got.value) == str(want.value) and detail in str(got.value)


@pytest.mark.parametrize("models", [None], ids=["tied"], indirect=True)
def test_mask_filler_device_contract(models):
    """The filler runs on the card unless the caller names the CPU, and
    refuses a model on another device than the one named."""
    tm = models[2]
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on cpu"):
            MaskFiller(tm, ByteTokenizer())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MaskFiller(tm, ByteTokenizer())


def language_perceiver_config():
    """``deepmind/language-perceiver`` as the JAX package's ``hf/convert.py``
    maps it (``PerceiverConfig(qk_channels=256, v_channels=1280)``)."""
    enc = TextEncoderConfig(vocab_size=262, max_seq_len=2048, num_input_channels=768,
                            num_cross_attention_qk_channels=256, num_cross_attention_v_channels=1280,
                            num_cross_attention_heads=8, num_self_attention_qk_channels=256,
                            num_self_attention_v_channels=1280, num_self_attention_heads=8,
                            num_self_attention_layers_per_block=26, num_self_attention_blocks=1)
    dec = TextDecoderConfig(vocab_size=262, max_seq_len=2048, num_cross_attention_qk_channels=256,
                            num_cross_attention_v_channels=768, num_cross_attention_heads=8,
                            cross_attention_residual=False)
    return MaskedLanguageModelConfig(encoder=enc, decoder=dec, num_latents=256, num_latent_channels=1280)


def test_language_perceiver_parameter_count_on_meta():
    """201,108,230 parameters (the published checkpoint's count, as
    ``tests/test_hf_convert.py`` holds the JAX conversion to it), built on
    the meta device: no memory for the weights."""
    model = MaskedLanguageModel(language_perceiver_config(), device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == 201_108_230
    assert model.tied


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskedLanguageModel(_configs()[1])
