"""The port's training slice against the JAX package at the micro geometry
(``analysis/flagship.py``: 128 latents, 64 channels, 4 heads, 2 layers,
cross-attention dropout 0.5; batches of 256 tokens): the full gradient tree
of ``clm_loss_fn`` under a fixed prefix keep set, unpadded (the compact
route) and left-padded (the embedded-row gather), and 3-step AdamW + global
clip + warmup trajectories against ``make_train_step`` on identical batches
and keep sets (``microbatch=2``; the non-finite skip on an injected NaN).
Plus the pieces: keep sets, schedules, the clip, the cross entropy, the
training forward's contracts and the train step's rejections.

Tolerances, each about four times the largest measured difference (f32;
the JAX package takes its einsum attention on the CPU, the port its flash
Function's plain backward, so sums run in other orders):

- gradients: per parameter, max abs difference over the JAX gradient's max
  abs value <= 4e-6 (measured 9.1e-7);
- losses (about 5.6) within 4e-6 (measured 9.5e-7, two f32 steps);
- parameters after three steps within atol 1e-6 (measured 2.4e-7; values
  of order 0.02 that the steps moved by up to 1.9e-3)."""

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
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu.training.losses import _cross_entropy as jax_cross_entropy
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.cache import init_kv_cache
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.training.losses import _cross_entropy

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX = 128, 256, 128
GRAD_RTOL = 4e-6
LOSS_ATOL, PARAM_ATOL = 4e-6, 1e-6


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


def _batch(rng, b, n_pad=0):
    t = rng.integers(0, 262, size=(b, SEQ + 1))
    pad = None
    if n_pad:
        pad = np.zeros((b, SEQ), bool)
        pad[1, :n_pad] = True
    keep = jpd.sample_prefix_keep_idx(rng, b, PREFIX, 0.5)
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": pad, "prefix_keep_idx": keep}


def _jax_batch(batch):
    return {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("n_pad", [0, 37], ids=["unpadded_compact", "left_padded_gather"])
def test_clm_gradient_tree_matches_jax(models, n_pad):
    jm, params = models
    batch = _batch(np.random.default_rng(1), 2, n_pad)
    jloss_fn = jax_clm_loss_fn(jm.apply, max_latents=LATENTS)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, _jax_batch(batch), jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm = _port_model(params)
    loss, _ = tt.clm_loss_fn(LATENTS)(tm, batch, None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        assert grads[name] is not None, name
        err = np.abs(grads[name].numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)


def _run_trajectory(models, microbatch, sentinel, batches):
    jm, params = models
    schedule = (joptim.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1),
                tt.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1))

    def poisoned(base):
        def loss_fn(*args):
            loss, _ = base(*args)
            loss = loss * args[1]["poison"]
            return loss, {"loss": loss}
        return loss_fn

    jloss = jax_clm_loss_fn(jm.apply, max_latents=LATENTS)
    tloss = tt.clm_loss_fn(LATENTS)
    if sentinel:
        jloss, tloss = poisoned(jloss), poisoned(tloss)
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(schedule[0], gradient_clip=1.0),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jloss, donate=False, microbatch=microbatch, sentinel=sentinel)
    tm = _port_model(params)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(schedule[1], gradient_clip=1.0))
    tstep = tt.make_train_step(tloss, microbatch=microbatch, sentinel=sentinel)
    jm_, tm_ = [], []
    for batch in batches:
        jstate, jmetrics = jstep(jstate, _jax_batch(batch))
        tstate, tmetrics = tstep(tstate, batch)
        jm_.append({k: float(v) for k, v in jmetrics.items()})
        tm_.append({k: float(v) for k, v in tmetrics.items()})
    assert int(jstate.step) == tstate.step == len(batches)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    return jm_, tm_, want, dict(tm.named_parameters()), state_dict_from_jax(params)


def _check_params(want, got, init):
    moved = max(float(np.abs(want[n].numpy() - init[n].numpy()).max()) for n in want)
    assert moved > 1e-4  # the steps did update the parameters
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_three_step_microbatched_trajectory_matches_jax(models):
    rng = np.random.default_rng(2)
    batches = [_batch(rng, 4) for _ in range(3)]
    jm_, tm_, want, got, init = _run_trajectory(models, 2, False, batches)
    np.testing.assert_allclose([m["loss"] for m in tm_], [m["loss"] for m in jm_], atol=LOSS_ATOL, rtol=0)
    _check_params(want, got, init)


def test_three_step_trajectory_with_sentinel_skip_matches_jax(models):
    """Step 2's loss is multiplied by NaN: both steps skip it (parameters,
    moments and the schedule count hold; the step advances)."""
    rng = np.random.default_rng(3)
    batches = [dict(_batch(rng, 2), poison=np.float32(p)) for p in (1.0, np.nan, 1.0)]
    jm_, tm_, want, got, init = _run_trajectory(models, 1, True, batches)
    assert [m["sentinel_skipped"] for m in tm_] == [m["sentinel_skipped"] for m in jm_] == [0.0, 1.0, 0.0]
    np.testing.assert_allclose([m["loss"] for m in tm_], [m["loss"] for m in jm_], atol=LOSS_ATOL, rtol=0)
    _check_params(want, got, init)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_prefix_keep_sets_match_jax():
    for prefix_len, p in ((7680, 0.5), (100, 0.3), (10, 0.0)):
        assert tt.prefix_keep_count(prefix_len, p) == jpd.prefix_keep_count(prefix_len, p)
        got = tt.sample_prefix_keep_idx(np.random.default_rng(5), 3, prefix_len, p)
        want = jpd.sample_prefix_keep_idx(np.random.default_rng(5), 3, prefix_len, p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    batches = [{"input_ids": np.zeros((2, 8))}, {"input_ids": np.ones((2, 8))}]
    got = list(tt.with_prefix_keep_idx(iter(batches), 6, 0.5, seed=1))
    want = list(jpd.with_prefix_keep_idx(iter(batches), 6, 0.5, seed=1))
    for g, w in zip(got, want):
        assert np.array_equal(g["prefix_keep_idx"], w["prefix_keep_idx"])


def test_schedules_match_jax():
    pairs = [
        (tt.cosine_with_warmup(2e-3, 100, 10, min_fraction=0.1), joptim.cosine_with_warmup(2e-3, 100, 10, min_fraction=0.1)),
        (tt.constant_with_warmup(1e-3, 4), joptim.constant_with_warmup(1e-3, 4)),
    ]
    for got, want in pairs:
        for step in (0, 1, 3, 4, 10, 55, 100, 130):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(6)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays], None)
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    norm = tt.clip_by_global_norm_(grads, max_norm)
    assert float(norm) == pytest.approx(float(np.sqrt(sum((a * a).sum() for a in arrays))), rel=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_adamw_steps_match_optax():
    """The optimizer without clip against optax's adamw with a schedule, on
    the same gradients: decoupled decay on every parameter, eps outside the
    sqrt, lr(t) from t = 0. Tolerance 1e-6 on parameters of order 1 (measured
    3.6e-7, three f32 steps: torch scales by 1 - lr * wd before the Adam step,
    optax adds the decay to the update)."""
    rng = np.random.default_rng(7)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (6,))]
    def schedule(t):
        return 1e-2 * (t + 1)

    tx = optax.adamw(schedule, weight_decay=0.05)
    jp = [jnp.asarray(a) for a in p0]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = tt.make_optimizer(schedule, weight_decay=0.05)(tp)
    for _ in range(3):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in p0]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5))
    labels[0, :3] = tt.IGNORE_INDEX
    for lab in (labels, np.full_like(labels, tt.IGNORE_INDEX)):
        got, n = _cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        want, wn = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        assert int(n) == int(wn)
        assert float(got) == pytest.approx(float(want), abs=1e-6)


def test_embed_compact_is_the_kept_rows_of_the_full_embedding(models):
    tm = _port_model(models[1])
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 262, size=(2, SEQ)))
    keep = torch.from_numpy(jpd.sample_prefix_keep_idx(rng, 2, PREFIX, 0.5)).long()
    with torch.no_grad():
        emb, frq = tm.input_adapter.embed_compact(x, keep, PREFIX)
        full_emb, full_frq = tm.input_adapter(x)
    rows = torch.cat([keep, torch.arange(PREFIX, SEQ).expand(2, -1)], dim=1)
    assert torch.equal(emb, torch.gather(full_emb, 1, rows[..., None].expand(-1, -1, emb.shape[2])))
    assert torch.equal(frq, torch.gather(full_frq, 1, rows[..., None].expand(-1, -1, frq.shape[2])))


def test_device_draw_is_topk_of_uniforms_from_the_generator(models):
    """Without a host keep set the keep set is the sorted top-k of
    ``torch.rand`` from the caller's generator: the port's RNG contract."""
    tm = _port_model(models[1])
    batch = _batch(np.random.default_rng(10), 2)
    x = torch.from_numpy(batch["input_ids"])
    rand = torch.rand((2, PREFIX), generator=torch.Generator().manual_seed(3))
    keep = torch.sort(torch.topk(rand, 64, dim=1).indices, dim=1).values
    with torch.no_grad():
        drawn = tm(x, PREFIX, deterministic=False, generator=torch.Generator().manual_seed(3)).logits
        given = tm(x, PREFIX, deterministic=False, prefix_keep_idx=keep).logits
    assert torch.equal(drawn, given)


def test_training_forward_contracts(models):
    tm = _port_model(models[1])
    x = torch.from_numpy(_batch(np.random.default_rng(11), 2)["input_ids"])
    with pytest.raises(ValueError, match="keeps 64 of 128"):
        tm(x, PREFIX, deterministic=False, prefix_keep_idx=torch.zeros((2, 63), dtype=torch.long))
    caches = tuple(init_kv_cache(2, 300, 64, 64, device="cpu") for _ in range(3))
    with pytest.raises(ValueError, match="not supported with caching"):
        tm(x, PREFIX, kv_cache=caches, deterministic=False)


@pytest.mark.parametrize("option", [
    dict(prefix_dropout_mode="mask"), dict(prefix_dropout_mode="gather_embed"),
    dict(post_attention_dropout=0.1), dict(residual_dropout=0.1), dict(activation_checkpointing=True),
])
def test_unported_training_options_raise(option):
    """Every training option of the JAX package's config is ported now: a
    training forward with it runs and differentiates (parity with JAX is in
    ``tests/test_torch_train_options.py``), and the deterministic forward
    is unaffected."""
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO, **option), device="cpu")
    x = torch.zeros((1, SEQ), dtype=torch.long)
    logits = tm(x, PREFIX, deterministic=False, generator=torch.Generator().manual_seed(0)).logits
    assert logits.shape == (1, SEQ - PREFIX, 262) and bool(torch.isfinite(logits).all())
    logits.square().mean().backward()
    assert all(p.grad is not None for p in tm.parameters())
    with torch.no_grad():  # the deterministic forward is unaffected
        plain = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")(x, PREFIX).logits
        assert torch.equal(tm(x, PREFIX).logits, plain)


def test_train_step_rejections(models):
    def masked(model, batch, generator):
        raise AssertionError("never called")

    masked.uniform_weighting = False
    with pytest.raises(ValueError, match="uniform_weighting=False"):
        tt.make_train_step(masked, microbatch=2)
    state = tt.TrainState.create(_port_model(models[1]), tt.make_optimizer(1e-3))
    step = tt.make_train_step(tt.clm_loss_fn(LATENTS), microbatch=2)
    with pytest.raises(ValueError, match="equal chunk weighting"):
        step(state, _batch(np.random.default_rng(12), 2, n_pad=5))
    with pytest.raises(ValueError, match="does not divide"):
        tt.make_train_step(tt.clm_loss_fn(LATENTS), microbatch=3)(state, _batch(np.random.default_rng(13), 4))
