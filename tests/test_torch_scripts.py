"""The port's training CLI (``scripts/``) against the JAX package's
``scripts/cli.py``, and short fits of the audio, MNIST and time-series task
CLIs on the CPU (``--trainer.accelerator=cpu``).

Covered: the dataclass-argument parser (every flag of the symbolic audio
model's config, the trainer's and the optimizer's, parsed and rebuilt as
JAX's are), YAML defaults under explicit flags and their unknown-key error,
the ``--smoke`` preset under explicit flags, ``activation_dtype``, the LR
schedules against JAX's; ``make_mesh_for`` (``dp`` on one device needs no
mesh; ``fsdp``, ``tp``, ``fsdp_tp``, ``seq`` and ``ring`` build one-process
meshes, an unknown one raises as JAX's);
``MNISTDataModule``'s synthetic digits and batches equal to JAX's; a two-step
``fit`` of each task CLI (``--smoke`` presets at micro widths) whose metrics
log holds finite losses, and ``validate`` after the audio fit reading its
checkpoint; the preprocessing CLI needing ``pretty_midi`` as JAX's does.
Schedules within 1e-6 relative (JAX evaluates them in f32, the port in
f64); everything else exact."""

import csv
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.vision import mnist as jmnist
from perceiver_io_tpu.models.audio import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.scripts import cli as jcli
from perceiver_io_tpu_torch.data.vision import mnist as tmnist
from perceiver_io_tpu_torch.models.audio import SymbolicAudioModelConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts import timeseries as ts_script
from perceiver_io_tpu_torch.scripts.audio import preproc as audio_preproc
from perceiver_io_tpu_torch.scripts.audio import symbolic as audio_script
from perceiver_io_tpu_torch.scripts.vision import image_classifier as image_script

ARGV = ["fit", "--trainer.max_steps=7", "--trainer.precision=bf16", "--trainer.gradient_clip_val=0.5",
        "--optimizer.lr=3e-4", "--optimizer.moment_dtype=bfloat16", "--optimizer.training_steps=None",
        "--model.num_channels=96", "--model.max_heads_parallel=2", "--model.abs_pos_emb=false",
        "--model.cross_attention_dropout=0.25"]


def _parse(mod, model_cls, argv, config_files=()):
    parser = mod.make_parser("sam", optimizer_defaults={"lr": 2e-4, "warmup_steps": 200})
    mod.add_dataclass_args(parser, model_cls, "model", {"max_latents": 1024, "num_channels": 512})
    mod.add_smoke_preset(parser, {"trainer.max_steps": 3, "model.num_self_attention_layers": 2})
    args = mod.parse_args(parser, [*argv, *(f"--config={c}" for c in config_files)])
    return (args, mod.build_dataclass(mod.TrainerArgs, args, "trainer"),
            mod.build_dataclass(mod.OptimizerArgs, args, "optimizer"),
            mod.build_dataclass(model_cls, args, "model", vocab_size=389))


def test_arguments_round_trip_as_jax():
    args, trainer, opt, model = _parse(cli, SymbolicAudioModelConfig, ARGV)
    jargs, jtrainer, jopt, jmodel = _parse(jcli, JaxSAMConfig, ARGV)
    assert args.command == jargs.command == "fit"
    assert dataclasses.asdict(model) == dataclasses.asdict(jmodel)
    assert (model.num_channels, model.max_latents, model.abs_pos_emb) == (96, 1024, False)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt) and opt.training_steps is None
    port_only = {"accelerator": "gpu", "tensorboard": True}
    assert dataclasses.asdict(trainer) == dict(dataclasses.asdict(jtrainer), **port_only)
    assert cli.activation_dtype(trainer) is torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        cli.activation_dtype(cli.TrainerArgs(precision="fp8"))


def test_yaml_defaults_and_the_smoke_preset_under_explicit_flags(tmp_path):
    path = tmp_path / "defaults.yaml"
    path.write_text("trainer:\n  max_steps: 11\n  log_interval: 5\noptimizer:\n  lr: 0.5\n")
    for mod, model_cls in ((cli, SymbolicAudioModelConfig), (jcli, JaxSAMConfig)):
        _, trainer, opt, _ = _parse(mod, model_cls, ["--trainer.max_steps=4"], [path])
        assert (trainer.max_steps, trainer.log_interval, opt.lr) == (4, 5, 0.5)
        _, trainer, _, model = _parse(mod, model_cls, ["--smoke", "--model.num_self_attention_layers=5"])
        assert (trainer.max_steps, model.num_self_attention_layers) == (3, 5)
    bad = tmp_path / "bad.yaml"
    bad.write_text("trainer:\n  max_stepz: 1\n")
    for mod, model_cls in ((cli, SymbolicAudioModelConfig), (jcli, JaxSAMConfig)):
        with pytest.raises(ValueError, match="unknown keys"):
            _parse(mod, model_cls, [], [bad])


@pytest.mark.parametrize("name", ["cosine_with_warmup", "constant_with_warmup", "none"])
def test_lr_schedules_match_jax(name):
    opt = dict(lr=1e-3, lr_scheduler=name, warmup_steps=3, min_fraction=0.1)
    ours, theirs = cli.make_lr_schedule(cli.OptimizerArgs(**opt), 20), jcli.make_lr_schedule(
        jcli.OptimizerArgs(**opt), 20)
    if name == "none":
        assert ours is None and theirs is None
        return
    for step in (0, 1, 3, 9, 20, 25):
        want = float(theirs(step))
        assert abs(float(ours(step)) - want) <= 1e-6 * abs(want)


def test_strategies_and_devices():
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape

    assert cli.make_mesh_for(cli.TrainerArgs(accelerator="cpu")) is None
    try:
        # one process: fsdp, tp, fsdp_tp, seq and ring build JAX's meshes
        # over a one-process gloo group the mesh starts itself
        for strategy, axis in (("fsdp", "fsdp"), ("tp", "tensor"), ("fsdp_tp", "tensor"), ("seq", "seq"),
                               ("ring", "seq")):
            mesh = cli.make_mesh_for(cli.TrainerArgs(accelerator="cpu", strategy=strategy))
            assert mesh_shape(mesh) == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1} and axis in mesh.mesh_dim_names
        assert cli.make_mesh_for(cli.TrainerArgs(accelerator="cpu")) is None  # dp on one process
        with pytest.raises(ValueError, match="one process per device"):
            cli.make_mesh_for(cli.TrainerArgs(accelerator="cpu", strategy="fsdp", devices=2))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="unknown strategy"):
        cli.make_mesh_for(cli.TrainerArgs(accelerator="cpu", strategy="ddp_spawn"))
    with pytest.raises(ValueError, match="unknown accelerator"):
        cli.device_for(cli.TrainerArgs(accelerator="tpu"))
    assert cli.device_for(cli.TrainerArgs()) == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            cli.make_mesh_for(cli.TrainerArgs())


def test_mnist_synthetic_digits_and_batches_match_jax():
    for n, seed in ((40, 0), (17, 3)):
        got, want = tmnist.synthetic_digits(n, seed=seed), jmnist.synthetic_digits(n, seed=seed)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    kwargs = dict(batch_size=8, synthetic=True, random_crop=24, seed=2)
    t, j = tmnist.MNISTDataModule(**kwargs), jmnist.MNISTDataModule(**kwargs)
    assert t.image_shape == j.image_shape == (24, 24, 1)
    for tb, jb in ((t.train_batches(), j.train_batches()), (t.valid_batches(), j.valid_batches())):
        for got, want in zip(list(tb)[:2], list(jb)[:2]):
            assert sorted(got) == sorted(want) == ["image", "label"]
            assert all(np.array_equal(got[k], want[k]) for k in want)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _fit(main, tmp_path, name, *argv):
    common = ["--trainer.accelerator=cpu", "--trainer.tensorboard=false", "--trainer.max_steps=2",
              "--trainer.log_interval=1", f"--trainer.default_root_dir={tmp_path}", f"--trainer.name={name}"]
    state, _ = main(["fit", "--smoke", *common, *argv])
    rows = _rows(tmp_path / name)
    losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    assert state.step == 2 and len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert any(r.get("val_loss") for r in rows)
    assert next(state.model.parameters()).device.type == "cpu"
    return state, common


def test_audio_fit_then_validate(tmp_path):
    argv = [f"--data.dataset_dir={tmp_path / 'sam_data'}", "--data.max_seq_len=64", "--data.batch_size=32",
            "--model.max_latents=16", "--model.num_channels=32", "--model.num_heads=2",
            "--model.num_self_attention_layers=1"]
    state, common = _fit(audio_script.main, tmp_path, "sam", *argv)
    assert state.model.config.vocab_size == 389 and state.model.config.max_seq_len == 64
    _, metrics = audio_script.main(["validate", "--smoke", *common, *argv])
    assert math.isfinite(metrics["val_loss"])


def test_mnist_fit(tmp_path):
    state, _ = _fit(image_script.main, tmp_path, "mnist", "--data.batch_size=128",
                    "--model.encoder.num_self_attention_layers_per_block=1")
    assert state.model.config.encoder.image_shape == (28, 28, 1)


def test_timeseries_fit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the smoke preset writes its synthetic CSV under .cache/
    val = tmp_path / "val.csv"  # 1000 rows: one validation batch of the smoke's 512 + 256 windows
    t = np.arange(1000)[:, None]
    np.savetxt(val, np.concatenate([t, np.sin(0.01 * t * np.arange(1, 8))], axis=1), delimiter=",", comments="",
               header="date," + ",".join(f"ch{i}" for i in range(7)), fmt="%.5f")
    state, _ = _fit(ts_script.main, tmp_path, "ts", "--data.batch_size=32", f"--data.val_path={val}",
                    "--model.num_latents=16", "--model.num_latent_channels=16",
                    "--model.encoder.num_self_attention_blocks=1")
    assert os.path.exists(tmp_path / ".cache" / "timeseries")
    assert state.model.config.decoder.out_len == 256


def test_preproc_needs_pretty_midi_as_jax(tmp_path):
    for split in ("train", "valid"):
        (tmp_path / split).mkdir()
        (tmp_path / split / "a.mid").write_bytes(b"MThd")
    with pytest.raises(ImportError, match="pretty_midi"):
        audio_preproc.main(["directory", f"--data.dataset_dir={tmp_path}"])
    with pytest.raises(ValueError, match="unknown dataset"):
        audio_script.build_audio_datamodule(audio_script.AudioDataArgs(dataset="nsynth"))


def test_cycle_refuses_a_loader_that_yields_no_batch():
    """The JAX package's ``cycle`` spins forever over an empty loader (a
    dataset smaller than one batch); the port's raises."""
    it = cli.cycle([])
    with pytest.raises(ValueError, match="yields no batch"):
        next(it)
    assert [next(cli.cycle([1, 2])) for _ in range(2)] == [1, 1]
