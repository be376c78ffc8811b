"""The port's torch-native checkpoints (``training/checkpoint.py``) on the
CPU: the in-place restore (every tensor keeps its storage; AdamW, the
compact bf16 moments, Lamb and accumulation's state; the generator), the
weights-only restore, the torn-save discipline of the JAX package's
``CheckpointManager`` (the startup sweep, integrity fallback, forced saves,
NaN-safe ``best_step``, best-k retention, I/O retry), ``preflight``, the
configs (a JAX ``config_to_dict`` loads into the port's class) and the
pretrained seam. Checks are exact: a restore copies bits."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxClassificationDecoderConfig
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.vision import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.training import checkpoint as jckpt
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.vision import ImageClassifierConfig, ImageEncoderConfig
from perceiver_io_tpu_torch.training.checkpoint import COMMIT_MARKER, QUARANTINE_DIR, STATE_FILE


class Tiny(torch.nn.Module):
    def __init__(self, seed=0, width=3):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lin = torch.nn.Linear(4, width)
        self.norm = torch.nn.LayerNorm(width)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        self.register_buffer("scale", torch.full((width,), 1.5))


def loss_fn(model, batch, generator=None):
    x = torch.as_tensor(batch["x"])
    if generator is not None:  # a draw, so that the generator's state moves with the steps
        x = x + 0.01 * torch.rand(x.shape, generator=generator)
    loss = ((model.norm(model.lin(x)) * model.scale - torch.as_tensor(batch["y"])) ** 2).mean()
    return loss, {"loss": loss}


OPTIMIZERS = {
    "adamw": dict(gradient_clip=1.0),
    "compact_bf16": dict(moment_dtype="bfloat16"),
    "lamb": dict(optimizer="lamb"),
    "adamw_accumulate": dict(accumulate_grad_batches=2),
}


def make_state(seed=0, optim="adamw", gen_seed=0):
    return tt.TrainState.create(Tiny(seed), tt.make_optimizer(1e-2, **OPTIMIZERS[optim]),
                                generator=torch.Generator().manual_seed(gen_seed))


def batch(i):
    rng = np.random.default_rng(i)
    return {"x": rng.normal(size=(8, 4)).astype(np.float32), "y": rng.normal(size=(8, 3)).astype(np.float32)}


def run(state, steps, start=0):
    step = tt.make_train_step(loss_fn, jit=False)
    for i in range(start, start + steps):
        state, _ = step(state, batch(i))
    return state


def tensors(state):
    return list(state.model.state_dict().values()) + state.optimizer.state_tensors()


@pytest.mark.parametrize("optim", list(OPTIMIZERS))
@pytest.mark.parametrize("enable_async", [False, True], ids=["sync", "async"])
def test_restore_is_in_place_and_exact(tmp_path, optim, enable_async):
    """Save after 3 steps, take 2 more, restore: every tensor (parameters,
    buffers, moments, AdamW's steps, the accumulation mean and counters, the
    count) holds the saved bits in its own storage, and the step and the
    generator's state are the saved ones; the restored state then steps as
    the original did."""
    state = run(make_state(optim=optim), 3)
    saved = [t.clone() for t in tensors(state)]
    saved_gen = state.generator.get_state()
    mngr = tt.CheckpointManager(str(tmp_path), monitor=None, enable_async=enable_async)
    assert mngr.save(state)
    run(state, 2, start=3)  # moves every tensor after the save returned
    ptrs = [t.data_ptr() for t in tensors(state)]
    assert mngr.restore(state) is state
    assert [t.data_ptr() for t in tensors(state)] == ptrs
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(tensors(state), saved))
    assert state.step == 3 and torch.equal(state.generator.get_state(), saved_gen)
    assert mngr.last_restore == {"step": 3, "optimizer": True}
    again = run(make_state(optim=optim), 5)
    run(state, 2, start=3)
    assert all(torch.equal(a, b) for a, b in zip(tensors(state), tensors(again)))
    mngr.close()


def test_weights_only_restore_zeroes_the_optimizer_in_place(tmp_path):
    state = run(make_state(optim="compact_bf16"), 3)
    weights = [t.clone() for t in state.model.state_dict().values()]
    wm = tt.CheckpointManager(str(tmp_path), monitor=None, save_weights_only=True)
    wm.save(state)
    wm.close()
    target = run(make_state(seed=5, optim="compact_bf16", gen_seed=9), 2)
    ptrs = [t.data_ptr() for t in tensors(target)]
    full = tt.CheckpointManager(str(tmp_path), monitor=None)  # a full-state manager reads it too
    full.restore(target)
    assert full.last_restore == {"step": 3, "optimizer": False}
    assert [t.data_ptr() for t in tensors(target)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(target.model.state_dict().values(), weights))
    fresh = make_state(optim="compact_bf16").optimizer.state_tensors()
    n = len(target.optimizer.params)
    assert all(torch.equal(a, b) for a, b in zip(target.optimizer.state_tensors()[n:], fresh[n:]))
    assert target.step == 3 and torch.equal(target.generator.get_state(), state.generator.get_state())
    # the reverse: a weights-only manager restores a full-state step whole
    fdir = tmp_path / "full"
    fm = tt.CheckpointManager(str(fdir), monitor=None)
    fm.save(state)
    fm.close()
    other = make_state(seed=6, optim="compact_bf16")
    tt.CheckpointManager(str(fdir), monitor=None, save_weights_only=True).restore(other)
    assert all(torch.equal(a, b) for a, b in zip(tensors(other), tensors(state)))


def test_checkpoint_layout_and_integrity_record(tmp_path):
    state = run(make_state(), 2)
    mngr = tt.CheckpointManager(str(tmp_path), monitor="val_loss", enable_async=True)
    assert mngr.save(state, metrics={"val_loss": 0.5}, config=CausalLanguageModelConfig(vocab_size=10,
                                                                                          max_seq_len=8,
                                                                                          max_latents=4))
    mngr.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["2", "config.json", "integrity.json"]
    assert sorted(os.listdir(tmp_path / "2")) == [COMMIT_MARKER, STATE_FILE]
    meta = json.load(open(tmp_path / "2" / COMMIT_MARKER))
    assert meta["weights_only"] is False and meta["metrics"] == {"val_loss": 0.5} and meta["generator"] == "cpu"
    assert meta["tensors"]["lin.weight"] == {"shape": [3, 4], "dtype": "torch.float32"}
    record = json.load(open(tmp_path / "integrity.json"))["steps"]["2"]
    assert record["files"] == 2 and record["bytes"] > 0 and record["metrics"] == {"val_loss": 0.5}
    assert mngr.saves[0]["step"] == 2 and mngr.saves[0]["bytes"] > 0 and mngr.saves[0]["write_s"] >= 0
    # a step at or before the latest committed one is not saved again
    assert mngr.save(state, metrics={"val_loss": 0.1}) is False
    assert isinstance(mngr.load_config(), CausalLanguageModelConfig)


def _linear_state(step, seed=0):
    state = make_state(seed=seed)
    state.step = step
    return state


def test_best_step_never_selects_nan_or_missing_metric(tmp_path):
    mngr = tt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=5, monitor="val_loss")
    mngr.save(_linear_state(1), metrics={"val_loss": 1.0})
    mngr.save(_linear_state(2), metrics={"val_loss": float("nan")})
    mngr.save(_linear_state(3), metrics={"val_loss": 0.7})
    mngr.save(_linear_state(4), force=True)  # a forced save carries no monitored metric
    assert mngr.best_step() == 3 and mngr.latest_step() == 4
    m2 = tt.CheckpointManager(str(tmp_path / "allnan"), max_to_keep=5, monitor="val_loss")
    m2.save(_linear_state(1), metrics={"val_loss": float("nan")})
    m2.save(_linear_state(2), metrics={"val_loss": float("nan")})
    assert m2.best_step() is None and m2.latest_step() == 2


def test_retention_keeps_the_best_k_and_every_forced_step(tmp_path):
    mngr = tt.CheckpointManager(str(tmp_path), max_to_keep=2, monitor="val_loss")
    for step, v in ((1, 0.9), (2, 0.5), (3, float("nan")), (4, 0.7), (5, 0.8)):
        mngr.save(_linear_state(step), metrics={"val_loss": v})
    mngr.save(_linear_state(6), metrics={"preempted": 1.0}, force=True)
    mngr.save(_linear_state(7), metrics={"val_loss": 0.6})
    assert mngr.valid_steps() == [2, 6, 7]
    latest = tt.CheckpointManager(str(tmp_path / "latest"), max_to_keep=2, monitor=None)
    for step in (1, 2, 3):
        latest.save(_linear_state(step))
    assert latest.valid_steps() == [2, 3]


def test_startup_sweep_quarantines_tmp_and_uncommitted(tmp_path):
    ckpt = tmp_path / "ckpt"
    mngr = tt.CheckpointManager(str(ckpt), monitor=None)
    mngr.save(_linear_state(1))
    mngr.close()
    (ckpt / "2.tmp-99").mkdir()  # a write killed before its rename
    (ckpt / "3").mkdir()  # renamed, killed before its commit marker
    (ckpt / "3" / STATE_FILE).write_bytes(b"partial")
    with pytest.warns(UserWarning, match="quarantined checkpoint dir"):
        m2 = tt.CheckpointManager(str(ckpt), monitor=None)
    assert sorted(m2.quarantined) == ["2.tmp-99", "3"]
    assert m2.latest_step() == 1
    assert m2.restore(make_state(seed=9)).step == 1
    assert any(n.startswith("3") for n in os.listdir(ckpt / QUARANTINE_DIR))


@pytest.mark.parametrize("tear", ["payload_removed", "payload_truncated_unrecorded"])
def test_restore_skips_a_torn_step_and_falls_back(tmp_path, tear):
    """A step mutilated after its commit fails its integrity record (or, with
    no record, cannot be read): it is quarantined and restore lands on the
    previous step, never on partial state."""
    ckpt = tmp_path / "ckpt"
    mngr = tt.CheckpointManager(str(ckpt), max_to_keep=3, monitor=None)
    for step in (1, 2):
        mngr.save(_linear_state(step, seed=step))
    mngr.close()
    if tear == "payload_removed":
        os.remove(ckpt / "2" / STATE_FILE)
    else:
        data = (ckpt / "2" / STATE_FILE).read_bytes()
        (ckpt / "2" / STATE_FILE).write_bytes(data[: len(data) // 2])
        os.remove(ckpt / "integrity.json")
    with pytest.warns(UserWarning, match="quarantined"):
        m2 = tt.CheckpointManager(str(ckpt), max_to_keep=3, monitor=None)
        restored = m2.restore(make_state(seed=9))
    assert restored.step == 1
    assert torch.equal(restored.model.lin.weight, make_state(seed=1).model.lin.weight)
    assert m2.latest_step() == 1 and os.path.isdir(ckpt / QUARANTINE_DIR)


def test_force_save_replaces_a_thinner_commit_only(tmp_path):
    state = run(make_state(), 3)
    ckpt = str(tmp_path / "ckpt")
    wm = tt.CheckpointManager(ckpt, monitor=None, save_weights_only=True)
    assert wm.save(state)
    wm.close()
    fm = tt.CheckpointManager(ckpt, monitor=None)
    with pytest.warns(UserWarning, match="quarantined"):
        assert fm.save(state, force=True)  # the weights-only commit is replaced
    assert fm._payload_has_opt_state(3)
    assert fm.save(state, force=True) is False  # a full-state commit never is
    fm.close()


def test_io_retry_emits_events_and_never_retries_file_not_found(tmp_path):
    class Sink:
        def __init__(self):
            self.rows = []

        def emit(self, kind, **fields):
            self.rows.append((kind, fields))

    sink = Sink()
    mngr = tt.CheckpointManager(str(tmp_path), monitor=None, retry=tt.RetryPolicy(max_retries=2, jitter=0.0),
                                event_sink=sink)
    mngr._retry_sleep = lambda s: None
    calls = {"n": 0}
    real = mngr._write_step

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return real(*args)

    mngr._write_step = flaky
    assert mngr.save(_linear_state(1))
    assert [r[1]["attempt"] for r in sink.rows if r[0] == "fault.ckpt_retry"] == [0, 1]
    assert mngr.latest_step() == 1

    def always(*args):
        raise OSError("disk gone")

    mngr._write_step = always
    with pytest.raises(OSError, match="disk gone"):  # out of retries: the write raises
        mngr.save(_linear_state(2))
    sink.rows.clear()
    with pytest.raises(FileNotFoundError):
        mngr._io_with_retry(lambda: (_ for _ in ()).throw(FileNotFoundError("torn")), "restore")
    assert not sink.rows
    # asynchronously, the failure raises at the next join
    amngr = tt.CheckpointManager(str(tmp_path / "async"), monitor=None, enable_async=True)
    amngr._write_step = always
    assert amngr.save(_linear_state(1))
    with pytest.raises(OSError, match="disk gone"):
        amngr.wait_until_finished()


def test_preflight_names_every_difference(tmp_path):
    config = CausalLanguageModelConfig(vocab_size=10, max_seq_len=8, max_latents=4)
    mngr = tt.CheckpointManager(str(tmp_path), monitor=None)
    mngr.save(run(make_state(), 1), config=config)
    assert mngr.preflight(make_state(seed=3), model_config=config) == {"step": 1, "reshard": False,
                                                                       "old_mesh": None, "new_mesh": None}
    wide = tt.TrainState.create(Tiny(width=5), tt.make_optimizer(1e-2), generator=None)
    drifted = CausalLanguageModelConfig(vocab_size=10, max_seq_len=8, max_latents=2)
    with pytest.raises(tt.ResumePreflightError) as err:
        mngr.preflight(wide, model_config=drifted)
    text = str(err.value)
    assert "config.max_latents" in text and "lin.weight: shape checkpoint=[3, 4] != state=[5, 4]" in text
    assert "optimizer[0]" in text and "generator: checkpoint='cpu' != state=None" in text


def test_a_jax_config_loads_into_the_ports_config(tmp_path):
    jax_clm = JaxCLMConfig(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64,
                           num_self_attention_layers=2, cross_attention_dropout=0.25)
    port_clm = CausalLanguageModelConfig(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64,
                                         num_self_attention_layers=2, cross_attention_dropout=0.25)
    assert tt.config_from_dict(jckpt.config_to_dict(jax_clm)) == port_clm
    jax_image = JaxImageClassifierConfig(
        encoder=JaxImageEncoderConfig(image_shape=(8, 8, 1), num_frequency_bands=4),
        decoder=JaxClassificationDecoderConfig(num_classes=2), num_latents=4, num_latent_channels=16)
    port_image = ImageClassifierConfig(
        encoder=ImageEncoderConfig(image_shape=(8, 8, 1), num_frequency_bands=4),
        decoder=ClassificationDecoderConfig(num_classes=2), num_latents=4, num_latent_channels=16)
    jckpt.save_config(str(tmp_path), jax_image)  # a JAX run's config.json
    loaded = tt.load_config(str(tmp_path))
    assert loaded == port_image and isinstance(loaded.encoder.image_shape, tuple)
    assert isinstance(loaded.decoder, ClassificationDecoderConfig)
    assert tt.config_from_dict(json.loads(json.dumps(tt.config_to_dict(port_image)))) == port_image
    with pytest.raises(ValueError, match="not one of the port's"):
        tt.config_from_dict({"__config_class__": "os.path.join"})


def test_pretrained_roundtrip_and_from_a_training_run(tmp_path):
    state = run(make_state(), 2)
    tt.save_pretrained(str(tmp_path / "pre"), state.model, config=CausalLanguageModelConfig(vocab_size=10))
    other = Tiny(seed=7)
    weights, config = tt.load_pretrained(str(tmp_path / "pre"), other)
    assert config.vocab_size == 10
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), state.model.state_dict().values()))
    runs = tmp_path / "run" / "checkpoints"
    mngr = tt.CheckpointManager(str(runs), max_to_keep=None, monitor="val_loss")
    for step, v in ((1, 0.3), (2, 0.9)):
        s = _linear_state(step, seed=step)
        mngr.save(s, metrics={"val_loss": v})
    weights, config = tt.load_pretrained(str(tmp_path / "run"))  # the best step by val_loss
    assert config is None and torch.equal(weights["lin.weight"], Tiny(seed=1).lin.weight.detach())


def test_load_params_into_subtree_selection():
    dst = {"encoder.w": torch.zeros(2), "encoder.b": torch.zeros(2), "decoder.w": torch.zeros(2)}
    src = {"encoder.w": torch.ones(2), "encoder.b": torch.full((2,), 2.0), "decoder.w": torch.full((2,), 3.0)}
    out = tt.load_params_into(dst, src, subtree="encoder")
    assert torch.equal(out["encoder.b"], src["encoder.b"]) and torch.equal(out["decoder.w"], torch.zeros(2))
    assert torch.equal(dst["encoder.w"], torch.zeros(2))  # not mutated
    with pytest.raises(KeyError, match="encoder"):
        tt.load_params_into(dst, src, subtree="missing_tower")
    assert torch.equal(tt.load_params_into(dst, src)["decoder.w"], src["decoder.w"])
    with pytest.raises(ValueError, match="shape"):
        tt.load_params_into(dst, {**src, "decoder.w": torch.zeros(3)})
