"""The causal LM's training options against the JAX package at the micro
geometry of ``tests/test_torch_train.py`` (128 latents, 64 channels, 4
heads, 2 layers, cross-attention dropout 0.5; batches of 2 x 256 tokens,
JAX weights carried across by ``convert``):

- the ``"mask"`` and ``"gather_embed"`` prefix-dropout modes with a given
  keep set, on unpadded and left-padded batches, on the concat route and
  (``"mask"``) under "twoseg": logits, loss and the gradient tree;
- attention-probability and residual dropout (``post_attention_dropout``,
  ``residual_dropout``) with masks drawn by numpy and fed to both packages
  (a test-local patch of ``flax.linen.Dropout.__call__``, keyed by the
  module's path and call, and of the port's ``keep_mask``), plain and with
  activation checkpointing or offloading on both sides;
- checkpointing and offloading in the port alone: logits and gradients
  equal to the plain forward's bit for bit, with and without dropout drawn
  from a generator, on both routes; the recompute reuses the first forward's
  masks (and a recompute that redraws them is caught); offloading hands the
  projections back instead of recomputing them;
- the dropout law itself.

Tolerances, those of ``tests/test_torch_train.py`` (f32; the JAX package
takes its einsum attention on the CPU, the port its plain versions): logits
atol 1e-4, gradients per parameter max abs difference over the JAX
gradient's max abs value <= 4e-6, loss atol 4e-6."""

import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import perceiver_io_tpu_torch.core.modules as tmodules
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu.training.losses import IGNORE_INDEX
from perceiver_io_tpu.training.losses import _cross_entropy as jax_cross_entropy
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.core.dropout import dropout, keep_mask
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels
from perceiver_io_tpu_torch.training.losses import _cross_entropy

# the module (the package re-exports a function of the same name)
jfa = importlib.import_module("perceiver_io_tpu.ops.flash_attention")

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX, KEEP = 128, 256, 128, 64
LOGIT_ATOL, GRAD_RTOL, LOSS_ATOL = 1e-4, 4e-6, 4e-6
RATE = 0.1
TWOSEG = frozenset({"twoseg"})


@pytest.fixture(scope="module")
def params():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))


def _port(params, **options):
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO, **options), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


def _batch(seed, n_pad=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 262, size=(2, SEQ + 1))
    pad = None
    if n_pad:
        pad = np.zeros((2, SEQ), bool)
        pad[1, :n_pad] = True
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": pad,
            "prefix_keep_idx": jpd.sample_prefix_keep_idx(rng, 2, PREFIX, 0.5)}


def _labels(batch):
    labels = batch["labels"]
    if batch["pad_mask"] is not None:
        labels = np.where(batch["pad_mask"], IGNORE_INDEX, labels)
    return labels[:, -LATENTS:]


def _jax_run(params, batch, **options):
    """(loss, logits, gradient state_dict) of the JAX model with ``options``."""
    jm = JaxCLM(JaxCLMConfig(**MICRO, **options))
    x = jnp.asarray(batch["input_ids"])
    pad = None if batch["pad_mask"] is None else jnp.asarray(batch["pad_mask"])
    keep = jnp.asarray(batch["prefix_keep_idx"])
    labels = jnp.asarray(_labels(batch))

    def loss_fn(p):
        out = jm.apply(p, x, prefix_len=PREFIX, pad_mask=pad, deterministic=False, prefix_keep_idx=keep,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_cross_entropy(out.logits, labels)[0], out.logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), np.asarray(logits), state_dict_from_jax(jax.tree.map(np.asarray, grads))


def _port_run(tm, batch, generator=None):
    """(loss, logits, gradients by name) of one training forward and backward."""
    tm.zero_grad(set_to_none=True)
    x = torch.from_numpy(batch["input_ids"])
    pad = None if batch["pad_mask"] is None else torch.from_numpy(batch["pad_mask"])
    keep = None if batch.get("prefix_keep_idx") is None else torch.from_numpy(batch["prefix_keep_idx"])
    out = tm(x, PREFIX, pad_mask=pad, deterministic=False, prefix_keep_idx=keep, generator=generator)
    loss, _ = _cross_entropy(out.logits, torch.from_numpy(_labels(batch)))
    loss.backward()
    return loss.detach(), out.logits.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}


def _check_against_jax(got, want):
    loss, logits, grads = got
    wloss, wlogits, wgrads = want
    assert abs(float(loss) - wloss) < LOSS_ATOL
    np.testing.assert_allclose(logits.numpy(), wlogits, atol=LOGIT_ATOL, rtol=0)
    assert sorted(grads) == sorted(wgrads)
    for name, w in wgrads.items():
        w = w.numpy()
        err = np.abs(grads[name].numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)


def _check_bitwise(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, g in want[2].items():
        assert torch.equal(got[2][name], g), name


# ---------------------------------------------------------------------------
# prefix-dropout modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,n_pad,route", [
    ("mask", 0, "concat"), ("mask", 37, "concat"), ("mask", 0, "twoseg"),
    ("gather_embed", 0, "concat"), ("gather_embed", 37, "concat"),
], ids=["mask-unpadded", "mask-left_padded", "mask-unpadded-twoseg", "gather_embed-unpadded",
        "gather_embed-left_padded"])
def test_prefix_dropout_mode_matches_jax(params, mode, n_pad, route):
    batch = _batch(1, n_pad)
    tm = _port(params, prefix_dropout_mode=mode)
    if route == "twoseg":
        # JAX's twoseg gate needs its fused kernels on (interpret mode here)
        with jfa.default_flash(True), jfa.fast_kernels(TWOSEG):
            want = _jax_run(params, batch, prefix_dropout_mode=mode)
        with fast_kernels(TWOSEG):
            got = _port_run(tm, batch)
    else:
        want = _jax_run(params, batch, prefix_dropout_mode=mode)
        got = _port_run(tm, batch)
    _check_against_jax(got, want)


def test_mask_mode_draws_the_gather_modes_keep_set(params):
    """Without a host keep set, "mask" keeps the uniforms at or above the
    keep-th largest: the set the gather modes' top-k keeps, from the same
    generator. The two modes then agree within f32 rounding (the softmax
    over the kept rows, summed in other orders)."""
    batch = dict(_batch(2), prefix_keep_idx=None)
    runs = {mode: _port_run(_port(params, prefix_dropout_mode=mode), batch, torch.Generator().manual_seed(3))
            for mode in ("gather", "gather_embed", "mask")}
    _check_bitwise(runs["gather_embed"], runs["gather"])
    np.testing.assert_allclose(runs["mask"][1].numpy(), runs["gather"][1].numpy(), atol=1e-5, rtol=0)
    assert abs(float(runs["mask"][0]) - float(runs["gather"][0])) < LOSS_ATOL


# ---------------------------------------------------------------------------
# attention and residual dropout, with masks fed to both packages
# ---------------------------------------------------------------------------


def _jax_path(name: str, site: str):
    """The Flax path of the dropout of port module ``name`` (a layer's
    residual dropout, or an attention's probability dropout)."""
    parts = name.split(".")
    layer = ("perceiver_ar", "cross_attention") if parts[0] == "cross_attention" else \
        ("perceiver_ar", "self_attention", f"layer_{parts[1]}")
    if site == "res":
        return layer + ("res_dropout",)
    inner = ("cross_attn",) if parts[0] == "cross_attention" else ("self_attn",)
    return layer + inner + ("attention", "attn_dropout")


class _FedMasks:
    """Keep masks drawn by numpy, keyed by (Flax path, call index), served
    to the JAX package's ``nn.Dropout`` and to the port's ``keep_mask``."""

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
        names = {id(m): n for n, m in tm.named_modules()}

        def jax_call(mod, inputs, deterministic=None, rng=None):
            deterministic = nn.merge_param("deterministic", mod.deterministic, deterministic)
            if mod.rate == 0.0 or deterministic:
                return inputs
            keep = jnp.asarray(self.get(tuple(mod.scope.path), inputs.shape))
            return jax.lax.select(keep, inputs / (1.0 - mod.rate), jnp.zeros_like(inputs))

        def port_keep(owner, site, shape, rate, generator, device):
            if rate == 0.0:
                return None
            path = _jax_path(names[id(owner)], "attn" if isinstance(owner, MultiHeadAttention) else "res")
            return torch.from_numpy(self.get(path, shape))

        monkeypatch.setattr(nn.Dropout, "__call__", jax_call)
        monkeypatch.setattr(tmodules, "keep_mask", port_keep)

    def reset(self):
        self.calls.clear()


@pytest.mark.parametrize("remat", [{}, {"activation_checkpointing": True}, {"activation_offloading": True}],
                         ids=["plain", "checkpointing", "offloading"])
def test_attention_and_residual_dropout_match_jax(params, monkeypatch, remat):
    options = dict(post_attention_dropout=RATE, residual_dropout=RATE, **remat)
    batch = _batch(4)
    tm = _port(params, **options)
    fed = _FedMasks(5)
    fed.patch(monkeypatch, tm)
    want = _jax_run(params, batch, **options)
    fed.reset()
    got = _port_run(tm, batch)
    # every site drew: the CA and 2 SA layers, probabilities + 2 residuals each
    assert len(fed.masks) == 9
    _check_against_jax(got, want)


# ---------------------------------------------------------------------------
# checkpointing and offloading in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["activation_checkpointing", "activation_offloading"])
@pytest.mark.parametrize("case", ["concat", "twoseg", "dropout", "mask-left_padded"])
def test_remat_equals_the_plain_forward_bit_for_bit(params, remat, case):
    """Logits and gradients with checkpointing or offloading equal the plain
    forward's bit for bit; with dropout drawn from a generator the layers'
    masks are the plain forward's (drawn before each body)."""
    options = dict(post_attention_dropout=RATE, residual_dropout=RATE) if case == "dropout" else {}
    if case == "mask-left_padded":
        options["prefix_dropout_mode"] = "mask"
    batch = _batch(6, 37 if case == "mask-left_padded" else 0)
    runs = []
    for extra in ({}, {remat: True}):
        tm = _port(params, **options, **extra)
        with fast_kernels(TWOSEG if case == "twoseg" else ()):
            runs.append(_port_run(tm, batch, torch.Generator().manual_seed(7)))
    _check_bitwise(runs[1], runs[0])


def test_recompute_with_redrawn_masks_is_caught(params, monkeypatch):
    """The bit-for-bit check above fails when a recompute draws its own
    masks: here each layer body redraws from the generator (which the
    forward has moved on since), as a checkpoint that does not replay the
    first forward's masks would."""
    options = dict(post_attention_dropout=RATE, residual_dropout=RATE)
    batch = _batch(8)
    plain = _port_run(_port(params, **options), batch, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    for cls in (tmodules.CrossAttentionLayer, tmodules.SelfAttentionLayer):
        body = cls._body

        def redrawn(self, *args, _body=body):
            masks = [None if m is None else torch.rand(m.shape, generator=gen) < 1.0 - RATE for m in args[-3:]]
            return _body(self, *args[:-3], *masks)

        monkeypatch.setattr(cls, "_body", redrawn)
    tm = _port(params, activation_checkpointing=True, **options)
    got = _port_run(tm, batch, gen)
    with pytest.raises(AssertionError):
        _check_bitwise(got, plain)


def test_offloading_hands_projections_back_instead_of_recomputing(params, monkeypatch):
    """In the backward, checkpointing recomputes every projection of the
    layers (one ``F.linear`` each); offloading recomputes none of them: it
    hands back the forward's outputs (kept in place on the CPU)."""
    batch = _batch(10)
    counts = {}
    for remat in ("activation_checkpointing", "activation_offloading"):
        tm = _port(params, **{remat: True})
        x = torch.from_numpy(batch["input_ids"])
        out = tm(x, PREFIX, deterministic=False, prefix_keep_idx=torch.from_numpy(batch["prefix_keep_idx"]))
        loss = out.logits.square().mean()
        calls = []
        linear = torch.nn.functional.linear
        monkeypatch.setattr(torch.nn.functional, "linear", lambda *a, **k: calls.append(1) or linear(*a, **k))
        loss.backward()
        monkeypatch.setattr(torch.nn.functional, "linear", linear)
        counts[remat] = len(calls)
    # the CA: q, k, v, o and 2 MLP projections; each SA layer the same
    assert counts == {"activation_checkpointing": 18, "activation_offloading": 0}


# ---------------------------------------------------------------------------
# the dropout law
# ---------------------------------------------------------------------------


def test_dropout_law():
    x = torch.randn(200, 500, dtype=torch.float64, generator=torch.Generator().manual_seed(0)).requires_grad_()
    keep = keep_mask(None, 0, x.shape, 0.3, torch.Generator().manual_seed(1), "cpu")
    share = float(keep.double().mean())
    assert abs(share - 0.7) < 5 * (0.7 * 0.3 / keep.numel()) ** 0.5  # five standard deviations
    y = dropout(x, keep, 0.3)
    assert torch.equal(y[keep], x[keep] / 0.7) and bool((y[~keep] == 0).all())
    assert keep_mask(None, 0, x.shape, 0.0, None, "cpu") is None and dropout(x, None, 0.0) is x
    zeros = dropout(x, keep_mask(None, 0, x.shape, 1.0, None, "cpu"), 1.0)
    assert not zeros.any() and not zeros.requires_grad  # zeros that carry no gradient, as Flax's


def test_deterministic_forward_ignores_dropout_and_remat(params):
    batch = _batch(11)
    x = torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        want = _port(params)(x, PREFIX).logits
        for options in (dict(post_attention_dropout=0.5, residual_dropout=0.5), dict(activation_offloading=True),
                        dict(prefix_dropout_mode="mask")):
            assert torch.equal(_port(params, **options)(x, PREFIX).logits, want), options
    # and a rate of 0 is no dropout in a training forward
    zero = _port_run(_port(params, post_attention_dropout=0.0, residual_dropout=0.0), batch)
    _check_bitwise(zero, _port_run(_port(params), batch))


@pytest.mark.parametrize("remat", ["activation_checkpointing", "activation_offloading"])
def test_recompute_follows_the_forward_route_after_the_scope(params, remat):
    """A backward run after the ``fast_kernels`` scope (as on the card,
    where autograd's device thread does not see the forward's context)
    recomputes on the forward's twoseg route: the gradients equal the
    plain step's bit for bit."""
    batch = _batch(12)
    runs = []
    for extra in ({}, {remat: True}):
        tm = _port(params, **extra)
        x = torch.from_numpy(batch["input_ids"])
        with fast_kernels(TWOSEG):
            out = tm(x, PREFIX, deterministic=False, prefix_keep_idx=torch.from_numpy(batch["prefix_keep_idx"]))
        out.logits.square().mean().backward()
        runs.append({n: p.grad for n, p in tm.named_parameters()})
    assert all(torch.equal(runs[1][n], g) for n, g in runs[0].items())
