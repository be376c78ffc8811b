"""The rest of ``make_optimizer`` against the JAX package's optax chains:
``"adam"`` (f32 and compact bf16 moments), ``"lamb"`` and ``"sgd"``,
``accumulate_grad_batches`` (optax's ``MultiSteps``, every call compared,
the non-emitting ones included), ``frozen_mask`` with weight decay on (a
frozen parameter must not move), ``freeze_mask`` against JAX's for the same
path strings, and a micro CLM's train step with accumulation, a frozen part
and Lamb against JAX's ``make_train_step``.

Each optimizer runs at least 4 updates from the same parameters and
gradients, with a warmup schedule and the global clip engaged on some
steps. Tolerances: parameters and f32 moments atol 1e-6 (f32; the two
frameworks round the bias corrections' powers and the clip's scale in
other places); bf16 moments bit for bit where the clip is off, as in
``tests/test_torch_bf16_optim.py``; a frozen parameter and its moments
exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax, state_dict_from_jax
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig

SHAPES = [(33, 16), (16,), (7, 5)]
NAMES = ["w", "b", "v"]
ATOL = 1e-6
MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)


def _schedules():
    return (joptim.constant_with_warmup(1e-2, 2), tt.constant_with_warmup(1e-2, 2))


def _find(state, attr):
    """The first sub-state of an optax state that has ``attr``."""
    if hasattr(state, attr):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find(s, attr)
            if found is not None:
                return found
    return None


def _run(calls, seed=0, frozen=None, **kwargs):
    """``calls`` optimizer calls of the JAX chain and of the port from the same
    parameters and gradients (mixed magnitudes: the clip at 1.0 engages on
    some calls). Returns per call the (JAX, port) parameters, and the final
    JAX state and port optimizer."""
    rng = np.random.default_rng(seed)
    p0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    gs = [[(rng.standard_normal(s) * 10 ** rng.uniform(-2, 0.5)).astype(np.float32) for s in SHAPES]
          for _ in range(calls)]
    jsched, tsched = _schedules()
    jmask = None if frozen is None else [n in frozen for n in NAMES]
    tmask = None if frozen is None else {n: n in frozen for n in NAMES}
    tx = joptim.make_optimizer(jsched, frozen_mask=jmask, **kwargs)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)

    @jax.jit
    def update(params, state, grads):
        u, state = tx.update(grads, state, params)
        return optax.apply_updates(params, u), state

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = tt.make_optimizer(tsched, frozen_mask=tmask, **kwargs)(list(zip(NAMES, tp)))
    trajectory = []
    for g in gs:
        jp, st = update(jp, st, [jnp.asarray(x) for x in g])
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        trajectory.append(([np.asarray(a) for a in jp], [p.detach().numpy().copy() for p in tp]))
    return trajectory, st, opt, p0


def _check_params(trajectory, p0):
    moved = max(np.abs(trajectory[-1][0][i] - p0[i]).max() for i in range(len(p0)))
    assert moved > 1e-4  # the updates did move the parameters
    for want, got in trajectory:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def _port_moments(opt):
    rule = opt.rule
    if opt.adamw is not None:
        return ([opt.adamw.state[p]["exp_avg"] for p in opt.params],
                [opt.adamw.state[p]["exp_avg_sq"] for p in opt.params])
    return rule.mu, rule.nu


@pytest.mark.parametrize("optimizer,moments", [("adam", None), ("adam", "bfloat16"), ("adamw", None),
                                               ("lamb", None), ("sgd", None)])
def test_optimizer_matches_the_optax_chain(optimizer, moments):
    clip = None if moments else 1.0  # bf16 moments bit for bit: no clip (see the module docstring)
    trajectory, st, opt, p0 = _run(5, seed=1, optimizer=optimizer, weight_decay=0.05, gradient_clip=clip,
                                   moment_dtype=moments)
    _check_params(trajectory, p0)
    assert int(opt.count) == 5
    adam = _find(st, "mu")
    if optimizer == "sgd":
        assert adam is None and opt.rule.state_tensors() == []
        return
    for want, got in zip((adam.mu, adam.nu), _port_moments(opt)):
        for w, g in zip(want, got):
            if moments:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("optimizer", ["adamw", "lamb"])
def test_accumulation_matches_multisteps_at_every_call(optimizer):
    """``accumulate_grad_batches=3`` over 7 calls: the parameters after every
    call (unchanged on the 2 of 3 that do not emit), the running mean and
    optax's ``mini_step`` / ``gradient_step``, and the inner count."""
    trajectory, st, opt, p0 = _run(7, seed=2, optimizer=optimizer, weight_decay=0.05, gradient_clip=1.0,
                                   accumulate_grad_batches=3)
    _check_params(trajectory, p0)
    for i in (0, 1, 3, 4, 6):  # non-emitting calls leave the parameters as they were
        before = p0 if i == 0 else trajectory[i - 1][1]
        assert all(np.array_equal(a, b) for a, b in zip(trajectory[i][1], before)), i
    assert int(opt.mini_step) == int(st.mini_step) == 1
    assert int(opt.gradient_step) == int(st.gradient_step) == 2
    assert int(opt.count) == 2
    for w, g in zip(st.acc_grads, opt.acc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("optimizer", ["adamw", "lamb"])
def test_frozen_parameters_do_not_move(optimizer):
    """With weight decay on, a frozen parameter ends every call as it began
    and its moments stay zero (optax's masked ``set_to_zero`` on gradients
    and updates); the rest follow the optax chain, whose clip norm leaves the
    frozen gradients out."""
    trajectory, st, opt, p0 = _run(4, seed=3, frozen={"b"}, optimizer=optimizer, weight_decay=0.1,
                                   gradient_clip=1.0)
    _check_params(trajectory, p0)
    for want, got in trajectory:
        assert np.array_equal(got[1], p0[1]) and np.array_equal(want[1], p0[1])
    for m in _port_moments(opt):
        assert not m[1].any()


def test_frozen_mask_needs_names_and_every_name():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="named parameters"):
        tt.make_optimizer(1e-3, frozen_mask={"a": True})(p)
    with pytest.raises(ValueError, match="every parameter"):
        tt.make_optimizer(1e-3, frozen_mask={"b": True})([("a", p[0])])
    with pytest.raises(ValueError, match="unknown optimizer"):
        tt.make_optimizer(1e-3, optimizer="adagrad")


@functools.lru_cache(maxsize=None)
def _clm_params():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 160), jnp.int32), prefix_len=96))


@functools.lru_cache(maxsize=None)
def _image_models():
    enc = dict(image_shape=(16, 16, 3), num_frequency_bands=8, num_cross_attention_heads=1,
               num_self_attention_heads=2, num_self_attention_layers_per_block=1, num_self_attention_blocks=2,
               first_self_attention_block_shared=False)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1)
    top = dict(num_latents=128, num_latent_channels=32)
    jm = JaxImageClassifier(JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc),
                                                     decoder=JaxDecoderConfig(**dec), **top))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    tm = ImageClassifier(ImageClassifierConfig(encoder=ImageEncoderConfig(**enc),
                                               decoder=ClassificationDecoderConfig(**dec), **top), device="cpu")
    return params, tm, image_classifier_state_dict_from_jax


@pytest.mark.parametrize("model,paths", [
    ("clm", ["perceiver_ar/self_attention"]), ("clm", ["input_adapter", "out_norm"]), ("clm", ["layer_1/mlp"]),
    ("image", ["encoder"]), ("image", ["decoder/cross_attn", "self_attn_n"]), ("image", ["coder"]),
])
def test_freeze_mask_marks_the_counterparts_of_jaxs(model, paths):
    if model == "clm":
        params = _clm_params()[1]
        tm, bridge = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu"), state_dict_from_jax
    else:
        params, tm, bridge = _image_models()
    jmask = joptim.freeze_mask(params, paths)
    # the JAX mask carried across by the weight bridge: True -> ones
    want = {n: bool(t.all()) for n, t in bridge(jax.tree.map(lambda m: np.full((1, 1), m, np.float32),
                                                              jmask)).items()}
    got = tt.freeze_mask(tm, paths)
    assert got == want
    assert any(got.values()) == (paths != ["coder"])  # whole segments only


def test_clm_train_step_with_accumulation_frozen_part_and_lamb_matches_jax():
    """A micro CLM's train step (microbatch 2, the sentinel on) with Lamb,
    ``accumulate_grad_batches=2`` and the self-attention stack frozen,
    against JAX's ``make_train_step`` over 4 calls: the losses, the
    parameters after them (the frozen ones unmoved) and the step count,
    which counts calls, as in JAX."""
    jm, params = _clm_params()
    paths = ["perceiver_ar/self_attention"]
    kwargs = dict(optimizer="lamb", weight_decay=0.01, gradient_clip=1.0, accumulate_grad_batches=2)
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(
        1e-3, frozen_mask=joptim.freeze_mask(params, paths), **kwargs), jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jax_clm_loss_fn(jm.apply, max_latents=128), donate=False, microbatch=2,
                                sentinel=True)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    init = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tstate = tt.TrainState.create(tm, tt.make_optimizer(1e-3, frozen_mask=tt.freeze_mask(tm, paths), **kwargs))
    tstep = tt.make_train_step(tt.clm_loss_fn(128), microbatch=2, sentinel=True)
    rng = np.random.default_rng(4)
    for _ in range(4):
        t = rng.integers(0, 262, size=(4, 257))
        batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
                 "prefix_keep_idx": jpd.sample_prefix_keep_idx(rng, 4, 128, 0.5)}
        jstate, jm_ = jstep(jstate, {k: None if v is None else jnp.asarray(v) for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) < 4e-6
    assert int(jstate.step) == tstate.step == 4 and int(tstate.optimizer.count) == 2
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.named_parameters():
        if name.startswith("self_attention."):
            assert torch.equal(p.detach(), init[name]), name
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=ATOL, rtol=0, err_msg=name)
    assert max(float((p.detach() - init[n]).abs().max()) for n, p in tm.named_parameters()) > 1e-4


def test_compact_update_by_buckets_is_the_whole_lists_update(monkeypatch):
    """The compact update over buckets of a few elements equals the update
    over one bucket bit for bit, through ``step`` and the sentinel's
    ``step_where`` (a false flag holds every bucket's parameters and
    moments and the count; a true one is ``step``)."""
    from perceiver_io_tpu_torch.training import optim as toptim

    rng = np.random.default_rng(5)
    p0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(4)]
    states = []
    for bucket in (1 << 23, 40):
        monkeypatch.setattr(toptim, "COMPACT_BUCKET", bucket)
        tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        opt = tt.make_optimizer(1e-2, gradient_clip=1.0, moment_dtype="bfloat16")(tp)
        assert len(opt.compact.buckets) == (1 if bucket > 1000 else 3)
        for i, g in enumerate(gs):
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x.copy())
            if i == 0:
                opt.step()
            else:
                held = [t.clone() for t in opt.state_tensors()]
                opt.step_where(torch.tensor(i != 2))
                if i == 2:
                    assert all(torch.equal(a, b) for a, b in zip(opt.state_tensors(), held))
        states.append([t.clone() for t in opt.state_tensors()])
    assert int(states[1][-1]) == 3
    assert all(torch.equal(a, b) for a, b in zip(states[0], states[1]))
