"""The port's ``Trainer`` against the JAX package's, on the CPU.

- ``Trainer.fit`` on the micro CLM (``tests/test_torch_train.py``'s
  ``MICRO``, weights through ``state_dict_from_jax``), the same batches and
  host keep sets, 6 steps, ``log_interval=2``, ``val_interval=3``, AdamW
  with clip 1.0 and a warmup-cosine schedule: the ``train_loss``,
  ``val_loss`` and ``lr`` columns of both ``metrics.csv`` files and the
  final parameters agree. Tolerances, about four times the largest measured
  difference (f32; JAX's einsum attention against the port's plain flash
  backward, so sums run in other orders): losses 3e-6 absolute (measured
  7.2e-7 in the window means of losses about 5.6), ``lr`` 1e-6 relative (f64
  against f32 schedules; measured 2.2e-7), parameters 1e-6 absolute
  (measured 2.4e-7, values of order 0.02).
- The same scripted NaN and spike steps through both trainers (a linear
  model whose loss the batch scales) give the same ``fault.*`` events:
  kinds, steps and reasons, through skip, spike, rollback and halt; a
  quarantined batch names the same leaf.
- The port alone: preempt then ``resume="auto"`` equals the uninterrupted run
  bit for bit (the micro CLM drawing its keep sets from the state's CPU
  generator, whose state rides in the checkpoint); prefetch residuals
  survive sequential fits; the rollback keeps every tensor's storage; the
  save-last, the weights-only rollback and the unported options.
"""

import csv
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.training import MetricsLogger as JaxMetricsLogger
from perceiver_io_tpu.training import SentinelConfig as JaxSentinelConfig
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import Trainer as JaxTrainer
from perceiver_io_tpu.training import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX = 128, 256, 128
LOSS_ATOL, LR_RTOL, PARAM_ATOL = 3e-6, 1e-6, 1e-6


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _events(log_dir, prefix=""):
    path = os.path.join(log_dir, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["event"].startswith(prefix)]


# ---------------------------------------------------------------------------
# the micro CLM: the port's fit against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    return jm, params


def _port_model(params):
    model = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _clm_batches(seed, n, b=2, keep=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, 262, size=(b, SEQ + 1))
        batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None}
        if keep:
            batch["prefix_keep_idx"] = jpd.sample_prefix_keep_idx(rng, b, PREFIX, 0.5)
        out.append(batch)
    return out


def test_fit_matches_jax_fit_on_the_micro_clm(micro, tmp_path):
    jm, params = micro
    batches = _clm_batches(1, 6)
    val = _clm_batches(2, 1, keep=False)
    settings = dict(max_steps=6, log_interval=2, val_interval=3, prefetch_batches=2)

    jsched = joptim.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1)
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(jsched, gradient_clip=1.0),
                                  jax.random.PRNGKey(1))
    jtr = JaxTrainer(jax_clm_loss_fn(jm.apply, max_latents=LATENTS),
                     config=JaxTrainerConfig(**settings, graphlint=False, graphcheck=False),
                     logger=JaxMetricsLogger(str(tmp_path / "jax"), use_tensorboard=False), lr_schedule=jsched)
    jout = jtr.fit(jstate, iter(batches), val_loader=val)
    jtr.close()

    tsched = tt.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1)
    model = _port_model(params)
    tstate = tt.TrainState.create(model, tt.make_optimizer(tsched, gradient_clip=1.0))
    ttr = tt.Trainer(tt.clm_loss_fn(LATENTS), config=tt.TrainerConfig(**settings),
                     logger=tt.MetricsLogger(str(tmp_path / "port"), use_tensorboard=False), lr_schedule=tsched)
    tout = ttr.fit(tstate, iter(batches), val_loader=val)
    ttr.close()
    assert tout is tstate and tout.step == int(jout.step) == 6

    jrows, trows = _csv_rows(tmp_path / "jax" / "metrics.csv"), _csv_rows(tmp_path / "port" / "metrics.csv")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == ["2", "3", "4", "6", "6"]
    for jr, tr in zip(jrows, trows):
        for col, tol in (("train_loss", LOSS_ATOL), ("val_loss", LOSS_ATOL)):
            assert (jr[col] == "") == (tr[col] == ""), col
            if jr[col]:
                assert abs(float(tr[col]) - float(jr[col])) <= tol, (col, jr["step"], tr[col], jr[col])
        if jr["lr"]:
            assert float(tr["lr"]) == pytest.approx(float(jr["lr"]), rel=LR_RTOL)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jout.params))
    got, init = dict(model.named_parameters()), state_dict_from_jax(params)
    assert max(float((init[n] - w).abs().max()) for n, w in want.items()) > 1e-4  # the fit moved them
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)
    # validation is deterministic (no prefix dropout), as JAX's default eval
    v1 = ttr.validate(tstate, val)
    assert v1 == ttr.validate(tstate, val)


def _micro_clm_state(params, seed=3):
    model = _port_model(params)
    return tt.TrainState.create(model, tt.make_optimizer(tt.cosine_with_warmup(1e-3, 8, 2), gradient_clip=1.0),
                                generator=torch.Generator().manual_seed(seed))


def test_preempt_then_auto_resume_equals_the_uninterrupted_run(micro, tmp_path):
    """The micro CLM, batches without keep sets (the forward draws them from
    the state's CPU generator): a fit tripped at step 4 and resumed from
    its checkpoint by a fresh Trainer and a fresh state gives the
    uninterrupted fit's losses, parameters, optimizer state and generator
    state bit for bit; metrics.csv holds each step once."""
    _, params = micro
    batches = _clm_batches(4, 8, keep=False)
    cfg = dict(max_steps=8, log_interval=1, val_interval=2, prefetch_batches=2)

    def trainer(root):
        return tt.Trainer(tt.clm_loss_fn(LATENTS), config=tt.TrainerConfig(checkpoint_dir=str(root / "ckpt"), **cfg),
                          logger=tt.MetricsLogger(str(root / "logs"), use_tensorboard=False))

    def record(tr, hook=None):
        losses, orig = [], tr._train_step

        def wrapped(state, batch):
            state, metrics = orig(state, batch)
            losses.append(float(metrics["loss"]))
            if hook is not None:
                hook(tr, state)
            return state, metrics

        tr._train_step = wrapped
        return losses

    val = _clm_batches(5, 1, keep=False)
    ref_tr = trainer(tmp_path / "ref")
    ref_losses = record(ref_tr)
    ref = ref_tr.fit(_micro_clm_state(params), iter(batches), val_loader=val)
    ref_tr.close()

    run = tmp_path / "run"
    t1 = trainer(run)

    def trip(tr, state):
        if state.step == 4:
            tr._preempt_guard.trip()

    part1 = record(t1, trip)
    assert t1.fit(_micro_clm_state(params), iter(batches), val_loader=val).step == 4
    t1.close()
    t2 = trainer(run)
    part2 = record(t2)
    out = t2.fit(_micro_clm_state(params, seed=99), iter(batches), val_loader=val, resume="auto")
    t2.close()
    assert part1 + part2 == ref_losses and len(ref_losses) == 8
    assert all(torch.equal(a, b) for a, b in zip(out.optimizer.state_tensors(), ref.optimizer.state_tensors()))
    assert torch.equal(out.generator.get_state(), ref.generator.get_state())
    (resume,) = _events(run / "logs", "resume")
    assert (resume["from_step"], resume["to_step"], resume["fast_forward_batches"]) == (0, 4, 4)
    assert _events(run / "logs", "fault.preempt")
    steps = [r["step"] for r in _csv_rows(run / "logs" / "metrics.csv")]
    assert steps == [r["step"] for r in _csv_rows(tmp_path / "ref" / "logs" / "metrics.csv")]


# ---------------------------------------------------------------------------
# a linear model on both trainers: the fault ladder's events
# ---------------------------------------------------------------------------


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))


def _port_loss(model, batch, generator=None):
    x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
    loss = ((x @ model.w - y) ** 2).mean() * torch.as_tensor(batch["scale"])[0]
    return loss, {"loss": loss}


def _jax_loss(params, batch, rng):
    loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2) * batch["scale"][0]
    return loss, {"loss": loss}


def _port_linear_state():
    return tt.TrainState.create(_Linear(), tt.make_optimizer(1e-2), generator=torch.Generator().manual_seed(0))


def _jax_linear_state():
    from perceiver_io_tpu.training import make_optimizer

    return JaxTrainState.create(None, {"w": jnp.zeros((3,))}, make_optimizer(1e-2), jax.random.PRNGKey(0))


def _linear_batches(seed=0, scale=None, nan_leaf=None):
    """Linear-regression batches, ``scale[i]`` multiplying the loss of the
    i-th (1-based; NaN poisons it, a large value spikes it); ``nan_leaf``
    (index, path) writes a NaN into one leaf of one batch."""
    rng = np.random.default_rng(seed)
    for i in itertools.count(1):
        x = rng.normal(size=(4, 3)).astype(np.float32)
        batch = {"x": x, "y": (x @ np.ones(3)).astype(np.float32),
                 "scale": np.full((1,), (scale or {}).get(i, 1.0), np.float32),
                 "aux": (np.zeros(2, np.float32), np.ones(2, np.float32))}
        if nan_leaf is not None and nan_leaf[0] == i:
            if nan_leaf[1] == "x":
                batch["x"] = x.copy()
                batch["x"][0, 0] = np.nan
            else:
                batch["aux"] = (batch["aux"][0], np.array([np.nan, 1.0], np.float32))
        yield batch


def _fit_both(tmp_path, batches, **cfg):
    """Fit the linear model on both trainers; returns each side's ``fault.*``
    events as (kind, step, reason, from_step, to_step, leaf) and whether it
    raised ``DivergenceHalt``."""
    from perceiver_io_tpu.training import DivergenceHalt as JaxHalt

    out = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        common = dict(log_interval=1, prefetch_batches=0, input_double_buffer=False,
                      checkpoint_dir=str(root / "ckpt"), **cfg)
        if side == "jax":
            c = dict(common, sentinel=JaxSentinelConfig(**cfg["sentinel"]) if "sentinel" in cfg else False)
            tr = JaxTrainer(_jax_loss, config=JaxTrainerConfig(**c, graphlint=False, graphcheck=False),
                            logger=JaxMetricsLogger(str(root / "logs"), use_tensorboard=False))
            state, halt = _jax_linear_state(), JaxHalt
        else:
            c = dict(common, sentinel=tt.SentinelConfig(**cfg["sentinel"]) if "sentinel" in cfg else False)
            tr = tt.Trainer(_port_loss, config=tt.TrainerConfig(**c),
                            logger=tt.MetricsLogger(str(root / "logs"), use_tensorboard=False))
            state, halt = _port_linear_state(), tt.DivergenceHalt
        halted = False
        try:
            tr.fit(state, batches(), val_loader=[next(_linear_batches(seed=7))])
        except halt:
            halted = True
        tr.close()
        out[side] = ([(e["event"], e.get("step"), e.get("reason"), e.get("from_step"), e.get("to_step"),
                       e.get("leaf")) for e in _events(root / "logs", "fault.")], halted)
    return out


def test_scripted_nan_and_spike_steps_give_jaxs_fault_events(tmp_path):
    """NaN at batch 2 (skip), a spike at 5 (noted), NaN at 7 and 8 (two
    consecutive skips: rollback to the step-6 checkpoint), NaN at 11 and 12,
    which after the rollback are steps 9 and 10 (the second rollback is past
    the limit: halt)."""
    scale = {2: np.nan, 5: 1e4, 7: np.nan, 8: np.nan, 11: np.nan, 12: np.nan}
    sentinel = dict(window=4, min_history=2, spike_factor=10.0, spike_patience=2, skip_limit=2, rollback_limit=1)
    got = _fit_both(tmp_path, lambda: _linear_batches(scale=scale), max_steps=12, val_interval=3, sentinel=sentinel)
    assert got["port"] == got["jax"]
    events, halted = got["port"]
    assert halted
    assert [(e[0], e[1], e[3], e[4]) for e in events] == [
        ("fault.skip", 2, None, None), ("fault.spike", 5, None, None), ("fault.skip", 7, None, None),
        ("fault.rollback", None, 8, 6), ("fault.skip", 9, None, None), ("fault.halt", 10, None, None)]


@pytest.mark.parametrize("leaf", ["x", "aux"])
def test_poison_batch_names_jaxs_leaf(tmp_path, leaf):
    got = _fit_both(tmp_path, lambda: _linear_batches(nan_leaf=(2, leaf)), max_steps=4,
                    quarantine_poison_batches=True)
    assert got["port"] == got["jax"]
    (event,) = got["port"][0]
    assert event[0] == "fault.poison_batch" and event[5] == ("['x']" if leaf == "x" else "['aux'][1]")


# ---------------------------------------------------------------------------
# the port's trainer alone
# ---------------------------------------------------------------------------


def _linear_trainer(root, **cfg):
    cfg = dict(log_interval=1, prefetch_batches=0, input_double_buffer=False, **cfg)
    return tt.Trainer(_port_loss, config=tt.TrainerConfig(**cfg),
                      logger=tt.MetricsLogger(str(root / "logs"), use_tensorboard=False))


def test_rollback_restores_in_place_and_keeps_every_tensor(tmp_path):
    """The rollback writes the checkpoint into the state's own tensors:
    every parameter and optimizer tensor keeps its storage, and the state
    holds the checkpoint's values when the rollback lands."""
    tr = _linear_trainer(tmp_path, max_steps=8, val_interval=3, checkpoint_dir=str(tmp_path / "ckpt"),
                         sentinel=tt.SentinelConfig(skip_limit=2, rollback_limit=2))
    state = _port_linear_state()
    ptrs = [t.data_ptr() for t in state.optimizer.state_tensors()]
    at_rollback = []
    orig_restore = tr.checkpoints.restore

    def restore(s, step=None):
        out = orig_restore(s, step)
        payload = tr.checkpoints._load_payload(tr.checkpoints.last_restore["step"])
        at_rollback.append(([t.clone() for t in out.optimizer.state_tensors()], payload))
        return out

    tr.checkpoints.restore = restore
    out = tr.fit(state, _linear_batches(scale={5: np.nan, 6: np.nan}), val_loader=[next(_linear_batches(seed=7))])
    assert out is state and out.step == 8
    assert [t.data_ptr() for t in state.optimizer.state_tensors()] == ptrs
    (rb,) = _events(tmp_path / "logs", "fault.rollback")
    assert (rb["from_step"], rb["to_step"], rb["opt_reinit"]) == (6, 3, False)
    ((tensors, saved),) = at_rollback
    assert saved["step"] == 3 and torch.equal(tensors[0], saved["model"]["w"])
    assert all(torch.equal(a, b) for a, b in zip(tensors[1:], saved["optimizer"]))
    tr.close()


def test_weights_only_rollback_reinitializes_the_optimizer(tmp_path):
    tr = _linear_trainer(tmp_path, max_steps=8, val_interval=3, checkpoint_dir=str(tmp_path / "ckpt"),
                         save_weights_only=True, sentinel=tt.SentinelConfig(skip_limit=2, rollback_limit=2))
    losses = []
    orig = tr._train_step

    def wrapped(state, batch):
        state, metrics = orig(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    tr._train_step = wrapped
    tr.fit(_port_linear_state(), _linear_batches(scale={5: np.nan, 6: np.nan}),
           val_loader=[next(_linear_batches(seed=7))])
    tr.close()
    (rb,) = _events(tmp_path / "logs", "fault.rollback")
    assert rb["opt_reinit"] is True and np.isfinite(losses[-1])


def test_halt_when_no_checkpoint_to_roll_back_to(tmp_path):
    tr = _linear_trainer(tmp_path, max_steps=6, sentinel=tt.SentinelConfig(skip_limit=1))
    with pytest.raises(tt.DivergenceHalt):
        tr.fit(_port_linear_state(), _linear_batches(scale={2: np.nan}))
    tr.close()
    assert _events(tmp_path / "logs", "fit_end")[-1]["aborted"] is True


def test_save_last_without_validation_and_fresh_auto_resume(tmp_path):
    tr = _linear_trainer(tmp_path, max_steps=3, checkpoint_dir=str(tmp_path / "ckpt"))
    out = tr.fit(_port_linear_state(), _linear_batches(), resume="auto")  # nothing to resume: a fresh start
    tr.close()
    assert out.step == 3 and not _events(tmp_path / "logs", "resume")
    mngr = tt.CheckpointManager(str(tmp_path / "ckpt"), monitor=None)
    assert mngr.latest_step() == 3
    restored = mngr.restore(_port_linear_state())
    assert restored.step == 3 and torch.equal(restored.model.w, out.model.w)


def test_log_rows_carry_the_window_telemetry(tmp_path):
    """Each log row carries throughput, input wait and goodput; with the
    analytic accounting, tokens_per_sec and model_flops_per_sec (no mfu on
    the CPU, which has no peak); the double buffer on the CPU leaves the
    losses as they were without it; fit_end carries the goodput breakdown
    and no capture (the CPU runs eagerly)."""
    runs = {}
    for buffered in (False, True):
        root = tmp_path / str(buffered)
        tr = tt.Trainer(_port_loss, config=tt.TrainerConfig(
            max_steps=4, log_interval=2, prefetch_batches=2, input_double_buffer=buffered,
            tokens_per_sample=10, flops_per_sample=1e3),
            logger=tt.MetricsLogger(str(root / "logs"), use_tensorboard=False))
        tr.fit(_port_linear_state(), _linear_batches())
        tr.close()
        runs[buffered] = _events(root / "logs", "log")
    assert [r["train_loss"] for r in runs[True]] == [r["train_loss"] for r in runs[False]]
    for row in runs[True]:
        assert row["tokens_per_sec"] > 0 and row["model_flops_per_sec"] > 0 and "mfu" not in row
        assert row["input_wait_ms"] >= 0 and 0 <= row["goodput"] <= 1
    (end,) = _events(tmp_path / "True" / "logs", "fit_end")
    assert end["recompiles"] == {"train_step": 0, "eval_step": 0} and "goodput" in end
    manifest = json.load(open(tmp_path / "True" / "logs" / "run_manifest.json"))
    assert manifest["torch_version"] == torch.__version__ and len(manifest["config_hash"]) == 12


def _tagged():
    for i in itertools.count():
        yield {"tag": np.full((1,), i, np.int32)}


def _tag_trainer(**cfg):
    def loss_fn(model, batch, generator=None):
        loss = (model.w * 0.0).sum()
        return loss, {"loss": loss, "tag": torch.as_tensor(batch["tag"]).float()[0]}

    tr = tt.Trainer(loss_fn, config=tt.TrainerConfig(log_interval=1000, **cfg))
    seen, orig = [], tr._train_step

    def wrapped(state, batch):
        state, metrics = orig(state, batch)
        seen.append(int(metrics["tag"]))
        return state, metrics

    tr._train_step = wrapped
    return tr, seen


def test_sequential_fits_lose_no_prefetched_batches():
    """Two fits sharing one iterator consume every batch exactly once: the
    prefetch's and the double buffer's unconsumed pulls are parked and
    re-injected by the next fit (``tests/test_checkpoint_trainer.py:376``)."""
    tr, seen = _tag_trainer(max_steps=5, prefetch_batches=2)
    it = _tagged()
    for phase_steps in (5, 15):
        tr.config.max_steps = phase_steps
        tr.fit(_port_linear_state(), it)
    assert seen == list(range(20)), seen


def test_residuals_survive_noop_and_unprefetched_fits():
    """``tests/test_checkpoint_trainer.py:439`` on the port: residuals survive
    a no-op fit and a prefetch-disabled fit that ends early."""
    tr, seen = _tag_trainer(max_steps=3, prefetch_batches=2)
    it = _tagged()

    def at(step):
        state = _port_linear_state()
        state.step = step
        return state

    tr.fit(at(0), it)
    tr.fit(at(3), it)  # a no-op fit: the state is already at max_steps
    tr.config.prefetch_batches, tr.config.max_steps = 0, 5
    tr.fit(at(3), it)
    tr.config.prefetch_batches, tr.config.max_steps = 2, 10
    tr.fit(at(0), it)
    assert seen == list(range(15)), seen


@pytest.mark.parametrize("option", ["mesh", "overlap", "graphlint", "graphcheck"])
def test_unported_options_raise(option, tmp_path):
    if option == "mesh":
        # a mesh is taken (one process here: the mesh starts a one-process
        # gloo group), and a checkpoint saved without a mesh restores onto
        # one (the elastic reshard; ROADMAP A12 part 2, slice 1)
        import torch.distributed as dist

        from perceiver_io_tpu_torch.parallel import make_mesh

        saved = _port_linear_state()
        manager = tt.CheckpointManager(str(tmp_path / "ckpt"), monitor=None)
        manager.save(saved)  # saved without a mesh
        try:
            mesh = make_mesh(device="cpu")
            assert tt.Trainer(_port_loss, mesh=mesh).mesh is mesh
            sharded = tt.shard_train_state(_port_linear_state(), mesh)
            assert sharded.mesh is mesh and tt.shard_train_state(sharded, mesh) is sharded
            with torch.no_grad():
                for p in sharded.model.parameters():
                    p.zero_()
            assert manager.restore(sharded) is sharded
            assert all(torch.equal(a.full_tensor(), b) for a, b in zip(sharded.model.parameters(),
                                                                       saved.model.parameters()))
        finally:
            manager.close()
            dist.destroy_process_group()
        return
    item = {"overlap": "A12 part 2", "graphlint": "A14", "graphcheck": "A14"}[option]
    with pytest.raises(NotImplementedError, match=item):
        tt.Trainer(_port_loss, config=tt.TrainerConfig(**{option: True}))


def test_graph_analyses_are_off_by_default_unlike_jax():
    assert (tt.TrainerConfig().graphlint, tt.TrainerConfig().graphcheck) == (False, False)
    assert (JaxTrainerConfig().graphlint, JaxTrainerConfig().graphcheck) == (True, True)
