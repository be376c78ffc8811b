"""The port's text CLIs (``scripts/text/``) against the JAX package's, on the
CPU (``--trainer.accelerator=cpu``).

Covered: a short ``fit`` of the causal LM (text file, with its sample
callback), masked LM (text file, with its mask-fill callback) and classifier
(synthetic) CLIs at micro widths, each with its steps and ``metrics.csv``; the parsed
model, trainer and optimizer dataclasses, the data module and the first
training batch (the CLM's host-sampled prefix keep sets included) equal to
JAX's for the same argv; the sample callback's greedy text and the mask-fill
callback's fills equal to JAX's on the same weights; the classifier's warm
start from an MLM artifact with the encoder frozen, its encoder bit for bit
the artifact's after the fit and its decoder trained; the preprocessing
CLI's cache equal to JAX's; ``--trainer.strategy=ring|seq`` fitting on one
process (and refused, before a model is built, by a task without a
sequence-parallel route)."""

import csv
import dataclasses
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.text.tokenizer import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.text import MaskedLanguageModel as JaxMLM
from perceiver_io_tpu.models.text import MaskedLanguageModelConfig as JaxMLMConfig
from perceiver_io_tpu.models.text import TextDecoderConfig as JaxTextDecoderConfig
from perceiver_io_tpu.models.text import TextEncoderConfig as JaxTextEncoderConfig
from perceiver_io_tpu.scripts import cli as jcli
from perceiver_io_tpu.scripts.text import classifier as jclassifier
from perceiver_io_tpu.scripts.text import clm as jclm
from perceiver_io_tpu.scripts.text import common as jcommon
from perceiver_io_tpu.scripts.text import mlm as jmlm
from perceiver_io_tpu.scripts.text import preproc as jpreproc
from perceiver_io_tpu_torch.convert import mlm_state_dict_from_jax, state_dict_from_jax
from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.text import MaskedLanguageModel, MaskedLanguageModelConfig
from perceiver_io_tpu_torch.models.text import TextDecoderConfig, TextEncoderConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.text import classifier, clm, common, mlm, preproc
from perceiver_io_tpu_torch.training import save_pretrained

CORPUS = "hello world, this is a tiny corpus for the causal language model. " * 40
CLM_ARGV = ["--data.max_seq_len=32", "--data.batch_size=2", "--model.max_latents=8", "--model.num_channels=32",
            "--model.num_self_attention_layers=1", "--model.num_heads=2", "--trainer.seed=4",
            "--optimizer.lr=3e-4"]
IO_ARGV = ["--data.max_seq_len=32", "--data.batch_size=16", "--model.encoder.num_input_channels=16",
           "--model.encoder.num_self_attention_layers_per_block=1", "--model.num_latents=4",
           "--model.num_latent_channels=16"]


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _fit(main, tmp_path, name, *argv, steps=2):
    common_flags = ["--trainer.accelerator=cpu", "--trainer.tensorboard=false", f"--trainer.max_steps={steps}",
                    "--trainer.log_interval=1", f"--trainer.val_interval={steps}",
                    f"--trainer.default_root_dir={tmp_path}", f"--trainer.name={name}"]
    state, _ = main(["fit", *argv, *common_flags])
    rows = _rows(tmp_path / name)
    losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    assert state.step == steps and len(losses) == steps and all(math.isfinite(v) for v in losses)
    assert any(r.get("val_loss") and math.isfinite(float(r["val_loss"])) for r in rows)
    assert next(state.model.parameters()).device.type == "cpu"
    return state


def _corpus(tmp_path):
    path = tmp_path / "train.txt"
    path.write_text(CORPUS)
    return path


def test_clm_fit_with_sample(tmp_path):
    train = _corpus(tmp_path)
    state = _fit(clm.main, tmp_path, "clm", "--data.dataset=textfile", f"--data.train_file={train}",
                 f"--data.cache_dir={tmp_path / 'cache'}", *CLM_ARGV, "--task.sample_prompt=hello",
                 "--task.num_sample_tokens=4")
    assert state.model.config.max_seq_len == 32 and state.model.config.vocab_size == 262
    samples = (tmp_path / "clm" / "samples.txt").read_text()
    assert samples.startswith("--- step 2 [generated_text] ---\nhello")


@pytest.fixture(scope="module")
def mlm_fit(tmp_path_factory):
    """One MLM fit (text file, with the mask-fill callback) for the MLM test
    and the classifier's warm start."""
    root = tmp_path_factory.mktemp("mlm")
    train = _corpus(root)
    state = _fit(mlm.main, root, "mlm", "--data.dataset=textfile", f"--data.train_file={train}", *IO_ARGV,
                 f"--data.cache_dir={root / 'cache'}", "--task.masked_samples=I have [MASK] it|a [MASK] b")
    return state, root


def test_mlm_fit_with_mask_fill(mlm_fit):
    state, root = mlm_fit
    assert state.model.config.encoder.max_seq_len == 32 and state.model.dtype == torch.float32
    samples = (root / "mlm" / "samples.txt").read_text().splitlines()
    assert samples[0] == "--- step 2 [masked_samples] ---" and len(samples) == 3
    assert samples[1].count(", ") >= 2


def test_classifier_warm_start_freezes_the_encoder_bit_for_bit(mlm_fit, tmp_path):
    mlm_state, _ = mlm_fit
    artifact = tmp_path / "mlm_artifact"
    save_pretrained(str(artifact), mlm_state.model, mlm_state.model.config)
    source = {k: v.clone() for k, v in mlm_state.model.state_dict().items()}
    clf_argv = ["--smoke", *IO_ARGV, f"--data.cache_dir={tmp_path / 'cache'}",
                "--model.decoder.num_output_query_channels=16", "--optimizer.warmup_steps=0",
                "--optimizer.lr=1e-2", f"--model.encoder.params={artifact}"]
    state = _fit(classifier.main, tmp_path, "clf", *clf_argv, "--model.encoder.freeze=true", steps=3)
    after = state.model.state_dict()
    encoder = [k for k in after if k.startswith(classifier.ENCODER_PREFIX + ".")]
    assert len(encoder) == len([k for k in source if k.startswith("0.")]) > 10
    assert all(torch.equal(after[k], source[k]) for k in encoder)
    # frozen, the decoder still trains from its init (the CLI builds from a
    # generator seeded --trainer.seed, 0); unfrozen, the encoder moves
    init = type(state.model)(state.model.config, device="cpu", generator=torch.Generator().manual_seed(0))
    decoder = [k for k in after if k.startswith("1.")]
    assert decoder and not any(torch.equal(after[k], init.state_dict()[k]) for k in decoder if k.endswith("weight"))
    fresh = _fit(classifier.main, tmp_path, "fresh", *clf_argv, steps=1)
    assert not all(torch.equal(fresh.model.state_dict()[k], source[k]) for k in encoder)
    # the whole model from a full artifact, strict
    full = tmp_path / "clf_artifact"
    save_pretrained(str(full), state.model, state.model.config)
    classifier.make_warm_start(str(full), None)(init)
    assert all(torch.equal(init.state_dict()[k], after[k]) for k in after)
    assert classifier.make_warm_start(None, None) is None


def _captured(monkeypatch, script, module, argv):
    """Run ``script.main(argv)`` with ``cli.run_training`` replaced by a
    recorder; returns its arguments."""
    seen = {}

    def run_training(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return None, None

    monkeypatch.setattr(module, "run_training", run_training)
    script.main(argv)
    return seen


def _first(iterator):
    batch = next(iterator)
    return {k: np.asarray(v) for k, v in batch.items() if v is not None}


@pytest.mark.parametrize("task", ["clm", "mlm", "classifier"])
def test_parsed_arguments_data_and_first_batch_equal_jax(task, tmp_path, monkeypatch):
    train = _corpus(tmp_path)
    argv = {"clm": ["fit", "--data.dataset=textfile", f"--data.train_file={train}", *CLM_ARGV,
                    "--model.cross_attention_dropout=0.25", "--task.sample_prompt=hi"],
            "mlm": ["fit", "--data.dataset=textfile", f"--data.train_file={train}", *IO_ARGV,
                    "--data.static_masking=true", "--trainer.precision=bf16"],
            "classifier": ["fit", "--smoke", *IO_ARGV, "--model.encoder.freeze=true", "--optimizer.lr=5e-4"]}[task]
    argv = [*argv, f"--data.cache_dir={tmp_path / 'cache'}"]
    ours = _captured(monkeypatch, {"clm": clm, "mlm": mlm, "classifier": classifier}[task], cli, argv)
    theirs = _captured(monkeypatch, {"clm": jclm, "mlm": jmlm, "classifier": jclassifier}[task], jcli, argv)
    # port: (build_model, model_config, loss_fn, train_iter, val, trainer, opt); JAX: (model, model_config,
    # loss builder, init batch, train_iter, val, trainer, opt)
    config, train_iter, val, trainer, opt = (ours["args"][i] for i in (1, 3, 4, 5, 6))
    jconfig, jtrain_iter, jval, jtrainer, jopt = (theirs["args"][i] for i in (1, 4, 5, 6, 7))
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    assert dataclasses.asdict(trainer) == dict(dataclasses.asdict(jtrainer), accelerator="gpu", tensorboard=True)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    for _ in range(3):
        got, want = _first(train_iter), _first(jtrain_iter)
        assert sorted(got) == sorted(want) and all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                                                   for k in want)
    if task == "clm":
        assert "prefix_keep_idx" in got and got["prefix_keep_idx"].shape == (2, 24 - int(24 * 0.25))
    got, want = list(val), list(jval)
    assert len(got) == len(want) > 0
    if task == "classifier":
        assert ours["kwargs"]["frozen_paths"] == theirs["kwargs"]["frozen_paths"] == ("input_adapter", "encoder")
    built = ours["args"][0]("cpu", torch.Generator().manual_seed(0))
    assert built.config == config and built.dtype == cli.activation_dtype(trainer)


def test_build_text_datamodule_equals_jax(tmp_path):
    assert sorted(common.DATASETS) == sorted(jcommon.DATASETS)
    assert [f.name for f in dataclasses.fields(common.TextDataArgs)] == [
        f.name for f in dataclasses.fields(jcommon.TextDataArgs)]
    assert dataclasses.asdict(common.TextDataArgs()) == dataclasses.asdict(jcommon.TextDataArgs())
    train = _corpus(tmp_path)
    for name in sorted(common.DATASETS):
        for task in ("clm", "mlm", "clf"):
            args = dict(dataset=name, max_seq_len=64, batch_size=3, train_file=str(train), cache_dir=None, seed=2)
            ours = common.build_text_datamodule(common.TextDataArgs(**args), task=task)
            theirs = jcommon.build_text_datamodule(jcommon.TextDataArgs(**args), task=task)
            assert type(ours).__name__ == type(theirs).__name__
            keys = ("task", "max_seq_len", "batch_size", "mask_prob", "static_masking", "word_masking", "seed",
                    "dataset_name", "dataset_config", "train_split", "valid_split")
            assert {k: getattr(ours, k, None) for k in keys} == {k: getattr(theirs, k, None) for k in keys}
    with pytest.raises(ValueError, match="unknown dataset"):
        common.build_text_datamodule(common.TextDataArgs(dataset="c5"), task="clm")
    with pytest.raises(ValueError, match="requires --data.train_file"):
        common.build_text_datamodule(common.TextDataArgs(dataset="textfile"), task="clm")


class _Logger:
    def __init__(self):
        self.texts = []

    def log_text(self, step, tag, text):
        self.texts.append((step, tag, text))


CLM = dict(vocab_size=262, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4, num_self_attention_layers=1)


def test_sample_callback_equals_jax():
    jm = JaxCLM(JaxCLMConfig(**CLM))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32), prefix_len=4)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CLM), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    for prompt, n in (("hello there", 6),):
        task = clm.CLMTaskArgs(sample_prompt=prompt, num_sample_tokens=n)
        ours, theirs = _Logger(), _Logger()
        clm.make_sample_callback(ByteTokenizer(), task)(types.SimpleNamespace(logger=ours),
                                                         types.SimpleNamespace(model=tm), 7)
        jtask = jclm.CLMTaskArgs(sample_prompt=prompt, num_sample_tokens=n)
        jclm.make_sample_callback(jm, JaxByteTokenizer(), jtask)(types.SimpleNamespace(logger=theirs),
                                                                  types.SimpleNamespace(params=params), 7)
        assert ours.texts == theirs.texts and ours.texts[0][2].startswith(prompt)
    silent = _Logger()
    clm.make_sample_callback(ByteTokenizer(), clm.CLMTaskArgs())(types.SimpleNamespace(logger=silent), None, 1)
    assert silent.texts == []


class _Jitted:
    def __init__(self, model):
        self.config = model.config
        self.apply = jax.jit(model.apply)


def test_mask_fill_callback_equals_jax():
    enc = dict(vocab_size=262, max_seq_len=32, num_input_channels=32, num_self_attention_layers_per_block=1)
    dec = dict(vocab_size=262, max_seq_len=32)
    top = dict(num_latents=8, num_latent_channels=32)
    jm = JaxMLM(JaxMLMConfig(encoder=JaxTextEncoderConfig(**enc), decoder=JaxTextDecoderConfig(**dec), **top))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32), jnp.int32)))
    tm = MaskedLanguageModel(MaskedLanguageModelConfig(encoder=TextEncoderConfig(**enc),
                                                       decoder=TextDecoderConfig(**dec), **top), device="cpu")
    tm.load_state_dict(mlm_state_dict_from_jax(params), strict=True)
    for samples in (["I have [MASK] it", "a [MASK] b [MASK]"], ["no mask here"]):
        ours, theirs = _Logger(), _Logger()
        mlm.make_mask_fill_callback(ByteTokenizer(), samples)(types.SimpleNamespace(logger=ours),
                                                              types.SimpleNamespace(model=tm), 3)
        jmlm.make_mask_fill_callback(_Jitted(jm), JaxByteTokenizer(), samples)(
            types.SimpleNamespace(logger=theirs), types.SimpleNamespace(params=params), 3)
        assert ours.texts == theirs.texts and len(ours.texts) == 1
    assert "mask filling failed" in ours.texts[0][2]


def test_preproc_cache_equals_jax(tmp_path):
    train = _corpus(tmp_path)
    for task in ("clm", "mlm"):
        for mod, root in ((preproc, "port"), (jpreproc, "jax")):
            mod.main(["textfile", f"--task={task}", f"--data.train_file={train}",
                      f"--data.cache_dir={tmp_path / root / task}", "--data.max_seq_len=16",
                      "--data.static_masking=true"])
        (ours,), (theirs,) = (list((tmp_path / root / task).glob("preproc-*.npz")) for root in ("port", "jax"))
        assert ours.name == theirs.name
        a, b = np.load(ours, allow_pickle=True), np.load(theirs, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and all(np.array_equal(np.asarray(x), np.asarray(y))
                                                    for x, y in zip(a[k].reshape(-1), b[k].reshape(-1))), k
    with pytest.raises(SystemExit):
        preproc.main(["c5"])


@pytest.mark.parametrize("strategy", ["ring", "seq"])
def test_ring_and_seq_raise_naming_a12_before_a_model_is_built(strategy, tmp_path, monkeypatch):
    """ROADMAP A12 part 1 ported them: ``ring`` and ``seq`` now fit, on one
    process here, through the prefix-sharded loss (``seq`` takes ``ring``'s
    route); a task without a sequence-parallel route still refuses them
    before a model is built."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape
    from perceiver_io_tpu_torch.scripts import cli

    train = _corpus(tmp_path)
    try:
        state = _fit(clm.main, tmp_path, strategy, "--data.dataset=textfile", f"--data.train_file={train}",
                     f"--data.cache_dir={tmp_path / 'cache'}", *CLM_ARGV, f"--trainer.strategy={strategy}")
        assert mesh_shape(state.mesh) == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    finally:
        dist.destroy_process_group()

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built")

    with pytest.raises(ValueError, match="sequence-parallel loss route"):
        cli.run_training(no_model, None, None, iter(()), None,
                         cli.TrainerArgs(accelerator="cpu", strategy=strategy), cli.OptimizerArgs())
