"""The port's tensor parallelism against the JAX package, on the CPU:
``training.loop.shard_train_state`` under ``tensor 2`` (2 gloo ranks),
``tensor 4`` and ``fsdp 2 x tensor 2`` (4 ranks) for the micro CLM of
``tests/test_torch_dist_train.py`` and a micro image classifier, 3 AdamW
updates under a clip that engages against JAX's unsharded step on the same
converted parameters and global batches (JAX's
``test_tensor_parallel_train_step_matches_unsharded`` tolerances: losses
``rtol`` 2e-5, parameters ``atol`` 5e-5); each parameter's placement against
JAX's ``param_shardings`` on a mesh of the same shape, apart from the
differences ROADMAP §C records; ``scripts.cli.make_mesh_for`` against JAX's
``tp`` and ``fsdp_tp`` meshes; and the text CLM CLI fitting under
``--trainer.strategy=tp`` as 2 processes. A checkpoint of the CLM trained
under ``fsdp 2 x tensor 2`` restores onto ``fsdp 4`` and, saved there, back
onto ``fsdp 2 x tensor 2`` (``restore(mesh=...)``): its parameters and Adam
moments whole, bit for bit, one ``resume.reshard`` event each. The ranks of
a batch block's tensor line draw its dropout alike.

The classifier holds the layers whose heads the tensor axis does not divide:
its one-head cross-attentions on every mesh, its two-head self-attention
under ``tensor 4`` (JAX splits their channels inside a head; the port keeps
them replicated). The CE loss counts the ``tensor`` ranks of a batch block in
both its count and its world size, so the global mean is JAX's.

The ranks are child processes running this file as a script: they import
torch and the port only, set one thread each and exchange numpy files with
the parent. The 4-rank world meets through a ``FileStore`` under
``tmp_path``; the 2-rank world through torchrun's variables, joined by
``parallel.mesh.make_mesh`` (the CLI's launch path).
"""

import csv
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(vocab_size=64, max_seq_len=64, max_latents=16, num_channels=32, num_heads=4,
             num_self_attention_layers=2, cross_attention_dropout=0.0)
LAT = MICRO["max_latents"]
IMAGE = dict(encoder=dict(image_shape=(8, 8, 3), num_frequency_bands=4, num_cross_attention_heads=1,
                          num_self_attention_heads=2, num_self_attention_layers_per_block=1,
                          num_self_attention_blocks=2),
             decoder=dict(num_classes=4, num_output_query_channels=16, num_cross_attention_heads=1),
             top=dict(num_latents=8, num_latent_channels=16))
GLOBAL_BATCH, STEPS, CLIP, LR = 4, 3, 0.05, 1e-3
LOSS_RTOL, PARAM_ATOL = 2e-5, 5e-5
# (world, mesh axes): the meshes each world runs
MESHES = {"tensor2": (2, {"data": 1, "tensor": 2}), "tensor4": (4, {"data": 1, "tensor": 4}),
          "fsdp2_tensor2": (4, {"data": 1, "fsdp": 2, "tensor": 2})}
MODELS = ("clm", "image")
CORPUS = "hello world, this is a tiny corpus for the causal language model. " * 40
CLI_ARGV = ["--data.dataset=textfile", "--data.max_seq_len=32", "--data.batch_size=2", "--model.max_latents=8",
            "--model.num_channels=32", "--model.num_self_attention_layers=1", "--model.num_heads=2",
            "--trainer.seed=4", "--optimizer.lr=3e-4", "--trainer.accelerator=cpu", "--trainer.tensorboard=false",
            "--trainer.log_interval=1", "--trainer.strategy=tp", "--trainer.max_steps=2", "--trainer.val_interval=2",
            "--trainer.name=tp"]
WORKER_TIMEOUT_S = 240


def _batches(name: str):
    """Three global batches: the CLM's with left pads and ``-100`` labels that
    give the batch blocks different counts of valid tokens."""
    rng = np.random.default_rng(0 if name == "clm" else 1)
    out = []
    for i in range(STEPS):
        if name == "image":
            out.append({"image": rng.normal(size=(GLOBAL_BATCH, 8, 8, 3)).astype(np.float32),
                        "label": rng.integers(0, 4, size=GLOBAL_BATCH)})
            continue
        t = rng.integers(0, MICRO["vocab_size"], size=(GLOBAL_BATCH, MICRO["max_seq_len"] + 1))
        pad = np.zeros((GLOBAL_BATCH, MICRO["max_seq_len"]), bool)
        labels = t[:, 1:].copy()
        if i == 1:
            pad[1, :7] = True
            pad[2, :30] = True
        if i == 2:
            labels[0, -LAT:-3] = -100
        out.append({"input_ids": t[:, :-1], "labels": labels, "pad_mask": pad})
    return out


def _port_model(name: str, weights):
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models import text, vision

    if name == "clm":
        model = text.CausalLanguageModel(text.CausalLanguageModelConfig(**MICRO), device="cpu")
    else:
        cfg = vision.ImageClassifierConfig(encoder=vision.ImageEncoderConfig(**IMAGE["encoder"]),
                                           decoder=ClassificationDecoderConfig(**IMAGE["decoder"]), **IMAGE["top"])
        model = vision.ImageClassifier(cfg, device="cpu")
    prefix = f"{name}/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in weights.items() if k.startswith(prefix)},
                          strict=True)
    return model


def _placements(model) -> dict:
    """``{name: [tensor dim, fsdp dim]}`` (-1 for none) of each DTensor
    parameter of a placed model."""
    out = {}
    for pname, p in model.named_parameters():
        dims = {"tensor": -1, "fsdp": -1}
        for axis, placement in zip(p.device_mesh.mesh_dim_names, p.placements):
            if axis in dims and placement.is_shard():
                dims[axis] = placement.dim
        out[pname] = [dims["tensor"], dims["fsdp"]]
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _steps_world(world: int, ref: dict, out: dict) -> dict:
    """Each mesh of this world's size runs both models; returns the trained
    states by ``(mesh, model)``."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh, shard_batch

    states = {}
    for mesh_name, (size, axes) in MESHES.items():
        if size != world:
            continue
        mesh = make_mesh(device="cpu", **axes)
        for name in MODELS:
            state = tt.shard_train_state(tt.TrainState.create(_port_model(name, ref), tt.make_optimizer(
                LR, gradient_clip=CLIP)), mesh, min_weight_size=0)
            loss = tt.clm_loss_fn(LAT) if name == "clm" else tt.classification_loss_fn()
            step = tt.make_train_step(lambda m, b, g, f=loss: f(m, b, g, deterministic=True))
            losses = []
            for batch in _batches(name):
                state, metrics = step(state, shard_batch(batch, mesh))
                losses.append(float(metrics["loss"]))
            out[f"{mesh_name}/{name}/losses"] = np.asarray(losses)
            for pname, p in state.model.named_parameters():
                out[f"{mesh_name}/{name}/p/{pname}"] = p.full_tensor().detach().numpy()
            for pname, dims in _placements(state.model).items():
                out[f"{mesh_name}/{name}/placement/{pname}"] = np.asarray(dims)
            states[mesh_name, name] = state
    return states


class Sink:
    """An ``emit()`` sink keeping the rows."""

    def __init__(self):
        self.rows = []

    def emit(self, kind, **fields):
        self.rows.append(dict(fields, event=kind))


def _reshard_world(d: str, ref: dict, trained, out: dict) -> None:
    """``trained`` (the CLM after its steps under fsdp 2 x tensor 2) saved
    and restored onto fsdp 4, that saved and restored back onto fsdp 2 x
    tensor 2: each restore's parameters and moments, whole, against
    ``trained``'s, and its reshard events' meshes."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh
    from perceiver_io_tpu_torch.training.checkpoint import _whole_payload

    def whole(state):
        weights, moments = _whole_payload(state, weights_only=False)
        return [t.detach().clone() for t in [*weights.values(), *moments]]

    want, source = whole(trained), trained
    for leg, axes in (("fsdp4", {"data": 1, "fsdp": 4}), ("fsdp2_tensor2", MESHES["fsdp2_tensor2"][1])):
        root = os.path.join(d, f"ckpt_{leg}")
        saver = tt.CheckpointManager(root, monitor=None)
        saver.save(source)
        saver.close()
        sink = Sink()
        manager = tt.CheckpointManager(root, monitor=None, event_sink=sink)
        manager.sync = dist.barrier
        fresh = tt.TrainState.create(_port_model("clm", ref), tt.make_optimizer(LR, gradient_clip=CLIP))
        source = manager.restore(fresh, mesh=make_mesh(device="cpu", **axes), min_weight_size=0)
        manager.close()
        got = whole(source)
        out[f"reshard/{leg}/equal"] = np.array(len(got) == len(want) and all(map(torch.equal, got, want)))
        out[f"reshard/{leg}/events"] = np.array(json.dumps([[r["old_mesh"], r["new_mesh"]] for r in sink.rows
                                                            if r["event"] == "resume.reshard"]))


def _cli_world(d: str) -> None:
    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape
    from perceiver_io_tpu_torch.scripts.text import clm

    argv = [*CLI_ARGV, f"--data.train_file={os.path.join(d, 'train.txt')}",
            f"--data.cache_dir={os.path.join(d, 'cache')}", f"--trainer.default_root_dir={os.path.join(d, 'cli')}"]
    state, _ = clm.main(["fit", *argv])
    assert state.step == 2 and mesh_shape(state.mesh)["tensor"] == 2


def _draws_world(out: dict) -> None:
    """Each rank's first draws from its batch block's generator under fsdp 2
    x tensor 2 (``training.loop.block_generator``), in rank order."""
    import types

    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import make_mesh
    from perceiver_io_tpu_torch.training.loop import block_generator

    mesh = make_mesh(device="cpu", **MESHES["fsdp2_tensor2"][1])
    state = types.SimpleNamespace(generator=torch.Generator().manual_seed(5), mesh=mesh)
    draws = [None] * dist.get_world_size()
    dist.all_gather_object(draws, torch.rand(4, generator=block_generator(state)).numpy())
    out["tensor_line_draws"] = np.stack(draws)


def _worker(scenario: str, rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel import dist as pdist
    from perceiver_io_tpu_torch.parallel.mesh import mesh_shape
    from perceiver_io_tpu_torch.scripts.cli import TrainerArgs, make_mesh_for

    torch.set_num_threads(1)
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    if world == 4:
        pdist.initialize("cpu", rank, world, store=dist.FileStore(os.path.join(d, "store_four"), world))
    else:
        assert pdist.maybe_initialize_distributed("cpu")  # torchrun's group, as the CLI joins it
    out = {f"mesh_for/{s}": np.asarray(list(mesh_shape(make_mesh_for(TrainerArgs(
        accelerator="cpu", strategy=s))).values())) for s in ("tp", "fsdp_tp")}
    states = _steps_world(world, ref, out)
    if world == 4:
        _reshard_world(d, ref, states["fsdp2_tensor2", "clm"], out)
        _draws_world(out)
    if world == 2:
        _cli_world(d)
    if rank == 0:
        np.savez(os.path.join(d, f"{scenario}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                PIO_GROUP_TIMEOUT_S="120", OMP_NUM_THREADS="1", **extra)


def _free_port() -> int:
    """A free port below Linux's ephemeral range, where the gloo worlds of
    other tests running at the same time open theirs."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def _spawn(scenario: str, world: int, d: str, port=None):
    procs = []
    for r in range(world):
        extra = {} if port is None else dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                                             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), d],
                                      env=_env(**extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _join(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _jax_specs(jm, params, port_model, axes) -> dict:
    """``{port name: [tensor dim, fsdp dim]}`` (-1 for none) in torch dims:
    JAX's ``param_shardings`` on a mesh of ``axes``, min_weight_size 0."""
    import jax
    from torch import nn

    from perceiver_io_tpu.parallel.mesh import make_mesh, param_shardings
    from perceiver_io_tpu_torch.convert import jax_param_paths

    n = int(np.prod(list(axes.values())))
    specs = param_shardings(params, make_mesh(devices=jax.devices()[:n], **axes), min_weight_size=0)
    by_path = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
               for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    linear = {f"{m}.weight" for m, mod in port_model.named_modules() if isinstance(mod, nn.Linear)}
    out = {}
    for name, path in jax_param_paths(port_model).items():
        spec = list(by_path[path]) + [None] * (port_model.get_parameter(name).dim() - len(by_path[path]))
        if name in linear:
            spec = spec[::-1]
        out[name] = [spec.index(a) if a in spec else -1 for a in ("tensor", "fsdp")]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxClassificationDecoderConfig
    from perceiver_io_tpu.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu.models.vision import image_classifier as jimage
    from perceiver_io_tpu.scripts.cli import TrainerArgs as JaxTrainerArgs
    from perceiver_io_tpu.scripts.cli import make_mesh_for as jax_make_mesh_for
    from perceiver_io_tpu.training import TrainState as JaxTrainState
    from perceiver_io_tpu.training import classification_loss_fn as jax_classification_loss_fn
    from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
    from perceiver_io_tpu.training import make_optimizer as jax_make_optimizer
    from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
    from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax, state_dict_from_jax

    d = str(tmp_path_factory.mktemp("dist_tp"))
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write(CORPUS)
    clm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO))
    image = jimage.ImageClassifier(jimage.ImageClassifierConfig(
        encoder=jimage.ImageEncoderConfig(**IMAGE["encoder"]),
        decoder=JaxClassificationDecoderConfig(**IMAGE["decoder"]), **IMAGE["top"]))
    clm_batch, image_batch = _batches("clm")[0], _batches("image")[0]
    params = {"clm": jax.tree.map(np.asarray, jax.jit(clm.init, static_argnames="prefix_len")(
                  jax.random.PRNGKey(0), clm_batch["input_ids"], prefix_len=MICRO["max_seq_len"] - LAT)),
              "image": jax.tree.map(np.asarray, jax.jit(image.init)(jax.random.PRNGKey(0), image_batch["image"]))}
    convert = {"clm": state_dict_from_jax, "image": image_classifier_state_dict_from_jax}
    weights = {f"{name}/{k}": v.numpy() for name in MODELS for k, v in convert[name](params[name]).items()}
    np.savez(os.path.join(d, "ref.npz"), **weights)
    procs = _spawn("four", 4, d) + _spawn("two", 2, d, port=_free_port())

    want = {}
    for name, jm, loss in (("clm", clm, jax_clm_loss_fn(clm.apply, max_latents=LAT, deterministic=True)),
                           ("image", image, jax_classification_loss_fn(image.apply, deterministic=True))):
        state = JaxTrainState.create(jm.apply, params[name], jax_make_optimizer(LR, gradient_clip=CLIP),
                                     jax.random.PRNGKey(1))
        step = jax.jit(jax_make_train_step(loss, jit=False))
        losses = []
        for batch in _batches(name):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        want[name] = (np.asarray(losses), {k: v.numpy() for k, v in convert[name](
            jax.tree.map(np.asarray, state.params)).items()})
        port = _port_model(name, weights)
        for mesh_name, (_, axes) in MESHES.items():
            want[f"{mesh_name}/{name}/specs"] = _jax_specs(jm, params[name], port, axes)
    want["mesh_for"] = {(s, n): [dict(jax_make_mesh_for(JaxTrainerArgs(strategy=s, devices=n)).shape)[a]
                                 for a in ("data", "fsdp", "tensor", "seq")]
                        for s in ("tp", "fsdp_tp") for n in (2, 4)}
    _join(procs)
    got = {}
    for scenario in ("four", "two"):
        got[scenario] = dict(np.load(os.path.join(d, f"{scenario}.npz")))
        got.update(got[scenario])
    return want, got, d


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", MODELS)
def test_tensor_parallel_steps_match_jax_unsharded_step(runs, name, mesh):
    want, got, _ = runs
    losses, params = want[name]
    np.testing.assert_allclose(got[f"{mesh}/{name}/losses"], losses, rtol=LOSS_RTOL)
    for pname, p in params.items():
        np.testing.assert_allclose(got[f"{mesh}/{name}/p/{pname}"], p, atol=PARAM_ATOL, rtol=0, err_msg=pname)


def _unsplit_heads(name: str, mesh: str) -> bool:
    """The projections of an attention whose heads the mesh's tensor axis
    does not divide (ROADMAP §C): the classifier's one-head cross-attentions,
    and under ``tensor 4`` its two-head self-attention."""
    if not any(f".attention.{p}_proj." in name for p in "qkvo"):
        return False
    return "cross_attn" in name or mesh == "tensor4"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", MODELS)
def test_placement_matches_jax_param_shardings(runs, name, mesh):
    """Every tensor dim is JAX's, apart from the layers whose heads the axis
    does not divide (replicated here, split inside a head by JAX); every
    other fsdp dim JAX shards is the port's (FSDP2 also shards, on dim 0,
    what JAX replicates: the values are the same)."""
    want, got, _ = runs
    specs = want[f"{mesh}/{name}/specs"]
    unsplit = []
    for pname, (j_tensor, j_fsdp) in specs.items():
        p_tensor, p_fsdp = got[f"{mesh}/{name}/placement/{pname}"].tolist()
        if j_tensor != p_tensor:
            assert p_tensor == -1 and _unsplit_heads(pname, mesh), (pname, j_tensor, p_tensor)
            unsplit.append(pname)
            continue  # its fsdp dim is chosen with no tensor dim to avoid
        if j_fsdp != -1:
            assert p_fsdp == j_fsdp, (pname, j_fsdp, p_fsdp)
    fired = [p for p, dims in specs.items() if dims[0] != -1 and p not in unsplit]
    # the rule fired on both MLP Linears, and on the attention projections
    # wherever the axis divides some attention's heads
    heads_split = not (name == "image" and mesh == "tensor4")
    assert any("q_proj" in p for p in fired) == any("o_proj" in p for p in fired) == heads_split
    assert any(p.endswith(".1.weight") for p in fired) and any(p.endswith(".3.weight") for p in fired)
    assert bool(unsplit) == (name == "image")


@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
def test_make_mesh_for_builds_jax_tp_meshes(runs, strategy):
    want, got, _ = runs
    for scenario, n in (("four", 4), ("two", 2)):
        assert got[scenario][f"mesh_for/{strategy}"].tolist() == want["mesh_for"][(strategy, n)]


def test_clm_cli_fits_under_tp_as_two_processes(runs):
    _, _, d = runs
    with open(os.path.join(d, "cli", "tp", "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert any(r.get("val_loss") and math.isfinite(float(r["val_loss"])) for r in rows)


@pytest.mark.parametrize("leg", ["fsdp4", "fsdp2_tensor2"])
def test_tensor_parallel_checkpoint_restores_across_meshes(runs, leg):
    """fsdp 2 x tensor 2 onto fsdp 4, then back: the 2-D placements' blocks
    (``parallel.mesh.local_chunk``, ``gather_full``) put the same whole
    tensors back, and each restore reports its change of mesh."""
    _, got, _ = runs
    four = got["four"]
    assert bool(four[f"reshard/{leg}/equal"])
    tp = {"data": 1, "fsdp": 2, "tensor": 2, "seq": 1}
    fsdp = {"data": 1, "fsdp": 4, "tensor": 1, "seq": 1}
    want = [[tp, fsdp]] if leg == "fsdp4" else [[fsdp, tp]]
    assert json.loads(str(four[f"reshard/{leg}/events"])) == want


def test_a_tensor_line_draws_alike_and_batch_blocks_apart(runs):
    """Under fsdp 2 x tensor 2 (ranks 0-1 and 2-3 the tensor lines of the
    two batch blocks) the ranks of a block draw alike, as the replicated
    residual dropout needs, and the blocks draw apart."""
    _, got, _ = runs
    draws = got["four"]["tensor_line_draws"]
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[2], draws[3])
    assert not np.array_equal(draws[0], draws[2])


def test_attention_dropout_and_tensor_with_seq_raise():
    """A tensor-parallel layer refuses dropout on its attention probabilities
    (it holds a block of the heads); ``tensor`` with ``seq`` waits for slice 2."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.core.modules import SelfAttentionLayer
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh

    layer = SelfAttentionLayer(4, 32, dropout=0.1)
    attention: MultiHeadAttention = layer[0].module.attention
    attention.shard_heads(2)
    assert (attention.num_heads, attention.qk_channels, attention.d_qk) == (2, 16, 8)
    with pytest.raises(NotImplementedError, match="tensor-parallel layer"):
        layer(torch.zeros(1, 3, 32), deterministic=False, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="A12 part 2, slice 2"):
        make_mesh(data=1, tensor=2, seq=2, device="cpu")


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
