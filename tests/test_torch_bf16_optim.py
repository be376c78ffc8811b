"""The compact Adam moments (``make_optimizer(..., moment_dtype="bfloat16")``)
against the JAX package's ``make_optimizer`` with ``moment_dtype``, which
chains optax's ``scale_by_adam_compact``, ``add_decayed_weights`` and
``scale_by_learning_rate`` (after ``clip_by_global_norm``): three steps from
the same gradients agree within 1e-6 relative on the parameters (f32; the
bias corrections' powers may differ in the last bit between the two
frameworks) and bit for bit on the bf16 moments (the same f32 operations in
the same order, rounded to nearest even on store).

With the clip engaged the clipped gradients themselves differ in their last
bit: the port's clip (shared with the f32 path, whose results stay as they
were) multiplies by ``max_norm / norm`` where optax divides by the norm and
multiplies by ``max_norm``, and the two norms sum in other orders. A moment
that lies at a bf16 rounding boundary then rounds to the other neighbour (1
element in 16448 over three steps, measured), and its parameter moves by
that bf16 step's share of one update. So with clip 1.0 the moments agree
within one bf16 step (2^-7 relative) and bit for bit in all but 0.1% of
elements, the parameters within 3 x lr x 2^-7 = 2.3e-5.

Plus the contract around it: the dtypes of the state, the rejection of
``moment_dtype`` outside Adam, the sentinel's hold of the bf16 moments, a
zero-gradient row under a rate-0 warmup step, and a bf16 CLM's train step
with compact moments against the JAX package's."""

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
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

SHAPES = [(257, 64), (64,), (1000,), (3, 5, 7)]


def _adam_state(state):
    """optax's ``ScaleByAdamState`` inside a chain's state."""
    if hasattr(state, "mu"):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _trajectory(lr, weight_decay, seed, zero_row=False, clip=None):
    """Three compact-Adam steps in JAX (jitted) and in the port from the same
    parameters and gradients (of mixed magnitudes: with ``clip`` the clip
    engages on some steps and not on others)."""
    rng = np.random.default_rng(seed)
    p0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    gs = [[(rng.standard_normal(s) * 10 ** rng.uniform(-4, 0.5)).astype(np.float32) for s in SHAPES]
          for _ in range(3)]
    if zero_row:
        for g in gs:
            g[0][0] = 0.0
    tx = joptim.make_optimizer(lr[0], gradient_clip=clip, moment_dtype="bfloat16", weight_decay=weight_decay)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)

    @jax.jit
    def update(params, state, grads):
        u, state = tx.update(grads, state, params)
        return optax.apply_updates(params, u), state

    for g in gs:
        jp, st = update(jp, st, [jnp.asarray(x) for x in g])
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = tt.make_optimizer(lr[1], gradient_clip=clip, moment_dtype="bfloat16", weight_decay=weight_decay)(tp)
    for g in gs:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    return (jp, _adam_state(st)), (tp, opt)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01, 0.05])
def test_compact_adamw_matches_the_optax_chain(weight_decay):
    (jp, jst), (tp, opt) = _trajectory((1e-3, 1e-3), weight_decay, seed=int(weight_decay * 100))
    for a, b in zip(jp, tp):
        a, b = np.asarray(a), b.detach().numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    for name, want, got in (("mu", jst.mu, opt.compact.mu), ("nu", jst.nu, opt.compact.nu)):
        for w, g in zip(want, got):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)), err_msg=name)
    assert int(opt.count) == int(jst.count) == 3


def test_compact_adamw_under_the_clip_follows_the_optax_chain():
    """Clip 1.0, engaged on two of the three steps (see the module docstring
    for why the clipped gradients, and so a few moments, differ by a
    rounding)."""
    (jp, jst), (tp, opt) = _trajectory((1e-3, 1e-3), 0.01, seed=0, clip=1.0)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=3 * 1e-3 * 2**-7, rtol=0)
    same = total = 0
    for w, g in zip(jst.mu + jst.nu, opt.compact.mu + opt.compact.nu):
        w, g = np.asarray(w.astype(jnp.float32)), g.float().numpy()
        np.testing.assert_allclose(g, w, rtol=2**-7, atol=0)
        same, total = same + int((g == w).sum()), total + g.size
    assert same >= 0.999 * total


def test_compact_adamw_with_a_warmup_schedule_matches_the_optax_chain():
    """A warmup-cosine schedule evaluated on the count tensor: the first step
    at a rate of 0, with one gradient row always 0 (its moments stay 0)."""
    (jp, jst), (tp, opt) = _trajectory((joptim.cosine_with_warmup(5e-2, 4, 1), tt.cosine_with_warmup(5e-2, 4, 1)),
                                       0.05, seed=3, zero_row=True)
    for a, b in zip(jp, tp):
        a, b = np.asarray(a), b.detach().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    for w, g in zip(jst.mu + jst.nu, opt.compact.mu + opt.compact.nu):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    assert torch.equal(opt.compact.nu[0][0], torch.zeros_like(opt.compact.nu[0][0]))


def test_zero_gradient_row_at_a_zero_rate_stays_put():
    """The NaN trap of a capturable AdamW that divides by the rate: at a
    warmup's rate-0 first step a parameter whose gradient (and second
    moment) is 0 must stay as it is, finite."""
    p = torch.nn.Parameter(torch.ones(4, 3))
    opt = tt.make_optimizer(tt.cosine_with_warmup(1e-2, 4, 2), moment_dtype="bfloat16", weight_decay=0.0)([p])
    g = torch.ones(4, 3)
    g[0] = 0.0
    p.grad = g
    opt.step()
    assert torch.equal(p.detach(), torch.ones(4, 3))
    p.grad = g.clone()
    opt.step()
    assert torch.isfinite(p).all() and torch.equal(p.detach()[0], torch.ones(3))
    assert bool((p.detach()[1:] < 1).all())


def test_compact_state_dtypes_and_tensors():
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    opt = tt.make_optimizer(1e-3, moment_dtype=torch.bfloat16)(params)
    assert opt.adamw is None
    assert all(m.dtype == torch.bfloat16 and m.shape == p.shape for m, p in zip(opt.compact.mu, params))
    assert all(v.dtype == torch.bfloat16 for v in opt.compact.nu)
    tensors = opt.state_tensors()
    assert len(tensors) == 3 * len(params) + 1 and tensors[-1] is opt.count
    assert opt.count.dtype == torch.int64 and opt.lr.dtype == torch.float32


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_moment_dtype_outside_adam_is_refused_as_in_jax(optimizer):
    """As in the JAX package, ``moment_dtype`` belongs to Adam: other
    optimizers refuse it with the same error."""
    with pytest.raises(ValueError, match="moment_dtype"):
        joptim.make_optimizer(1e-3, optimizer=optimizer, moment_dtype="bfloat16")
    with pytest.raises(ValueError, match="moment_dtype"):
        tt.make_optimizer(1e-3, optimizer=optimizer, moment_dtype="bfloat16")


def test_compact_adam_without_decay_is_not_ported():
    """``"adam"`` with compact moments is ported now and does not quietly
    become AdamW: with a decay set, its parameters and bf16 moments after
    three steps are the JAX package's ``make_optimizer("adam",
    moment_dtype="bfloat16")`` chain's (no decay), as in the test above."""
    rng = np.random.default_rng(4)
    p0 = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(3)]
    tx = joptim.make_optimizer(1e-3, optimizer="adam", moment_dtype="bfloat16", weight_decay=0.05)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = tt.make_optimizer(1e-3, optimizer="adam", moment_dtype="bfloat16", weight_decay=0.05)(tp)
    for g in gs:
        u, st = jax.jit(tx.update)([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for a, b in zip(jp, tp):
        a, b = np.asarray(a), b.detach().numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    jst = _adam_state(st)
    for w, g in zip(jst.mu + jst.nu, opt.compact.mu + opt.compact.nu):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_sentinel_holds_the_bf16_moments():
    """``step_where`` with a false flag holds parameters, bf16 moments and the
    count bit for bit; with a true flag it is ``step``'s update exactly."""
    rng = np.random.default_rng(9)
    params = [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32))) for s in SHAPES]
    twin = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opt, ref = (tt.make_optimizer(1e-3, gradient_clip=1.0, moment_dtype="bfloat16")(ps) for ps in (params, twin))
    for step in range(3):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
        ok = step != 1
        for ps in (params, twin):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        held = [t.clone() for t in opt.state_tensors()]
        opt.step_where(torch.tensor(ok))
        if ok:
            ref.step()
            assert all(torch.equal(a, b) for a, b in zip(opt.state_tensors(), ref.state_tensors()))
        else:
            assert all(torch.equal(a, b) for a, b in zip(opt.state_tensors(), held))
    assert int(opt.count) == 2


MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)


def test_bf16_clm_train_steps_with_compact_moments_follow_jax():
    """Two ``make_train_step`` steps (microbatch 2, the sentinel on) of the
    bf16 CLM with bf16 moments, port and JAX from the same parameters,
    batches and keep sets: the losses lie within the bf16 forward's rounding
    of each other (|diff| <= 2e-3 on losses of about 5.6; the bf16 logits
    carry ~2^-9 relative error). The first Adam steps move each parameter by
    about lr * sign(gradient), and a gradient within bf16 rounding of 0 (the
    embedding tables' sum in bf16 in JAX and in f32 in the port, among
    others) may take either sign: every parameter lies within two such
    moves of JAX's (2 x 2 x lr), and 99.5% of them within 2e-4."""
    jm = JaxCLM(JaxCLMConfig(**MICRO), dtype=jnp.bfloat16)
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(1e-3, gradient_clip=1.0,
                                                                        moment_dtype="bfloat16"),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jax_clm_loss_fn(jm.apply, max_latents=128), donate=False, microbatch=2,
                                sentinel=True)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(1e-3, gradient_clip=1.0, moment_dtype="bfloat16"))
    tstep = tt.make_train_step(tt.clm_loss_fn(128), microbatch=2, sentinel=True)
    rng = np.random.default_rng(4)
    for _ in range(2):
        t = rng.integers(0, 262, size=(4, 257))
        batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
                 "prefix_keep_idx": jpd.sample_prefix_keep_idx(rng, 4, 128, 0.5)}
        jstate, jmetrics = jstep(jstate, {k: None if v is None else jnp.asarray(v) for k, v in batch.items()})
        tstate, tmetrics = tstep(tstate, batch)
        assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= 2e-3
        assert float(tmetrics["sentinel_skipped"]) == 0.0
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    close = total = 0
    for name, p in tm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * 2 * 1e-3, name
        close, total = close + int((diff <= 2e-4).sum()), total + diff.size
    assert close >= 0.995 * total
    assert all(m.dtype == torch.bfloat16 for m in tstate.optimizer.compact.mu)
