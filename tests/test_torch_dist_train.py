"""The port's training across processes against the JAX package, on the CPU:
``training.loop.shard_train_state`` and ``make_train_step`` on a sharded
state (``dp``, ``fsdp``, ``data x fsdp`` and the ``seq`` ring loss on 4 gloo
ranks) for 3 steps against JAX's unsharded step on the same converted
parameters, batches with pad masks and ``-100`` labels included, with AdamW
under a clip that engages and with LAMB (whole-tensor norms); the mesh's
errors; ``Trainer(mesh=...)`` fitting, checkpointing and resuming on 2 ranks
against the 1-process fit; a restore, and a re-placement, onto a mesh of
another shape; and the
text CLM CLI run as 2 processes with ``--trainer.accelerator=cpu`` under the
``dp``, ``fsdp`` (with an auto-resume), ``seq`` and ``ring`` strategies.

The ranks are child processes running this file as a script: they import
torch and the port only (never JAX, never ``tests/conftest.py``), set one
thread each and exchange numpy files with the parent, which computes the
references. The 4-rank world meets through a ``FileStore`` under
``tmp_path``; the 2-rank world through torchrun's variables and a port picked
at run time, joined by ``parallel.mesh.make_mesh`` itself (through
``parallel.dist.maybe_initialize_distributed``, the CLI's launch path too).
Each group has a timeout.
"""

import csv
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
GLOBAL_BATCH, STEPS = 4, 3
CLIP = 0.05
# the 4-rank configurations: (mesh axes, optimizer)
CONFIGS = {"dp": ({"data": 4}, "adamw"), "fsdp": ({"data": 1, "fsdp": 4}, "adamw"),
           "data2_fsdp2": ({"data": 2, "fsdp": 2}, "adamw"), "ring": ({"data": 1, "seq": 4}, "adamw"),
           "fsdp_lamb": ({"data": 1, "fsdp": 4}, "lamb")}
# losses: one f32 reduction order against another; parameters after three
# updates (JAX's own sharded-step tolerance, tests/test_seq_parallel_step.py)
LOSS_RTOL, PARAM_ATOL = 2e-5, 5e-5
CORPUS = "hello world, this is a tiny corpus for the causal language model. " * 40
CLI_ARGV = ["--data.dataset=textfile", "--data.max_seq_len=32", "--data.batch_size=2", "--model.max_latents=8",
            "--model.num_channels=32", "--model.num_self_attention_layers=1", "--model.num_heads=2",
            "--trainer.seed=4", "--optimizer.lr=3e-4", "--trainer.accelerator=cpu", "--trainer.tensorboard=false",
            "--trainer.log_interval=1"]
WORKER_TIMEOUT_S = 240


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                PIO_GROUP_TIMEOUT_S="120", OMP_NUM_THREADS="1", **extra)


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


def _free_port() -> int:
    """A free port below Linux's ephemeral range (32768-60999), where the
    gloo worlds of other tests running at the same time open theirs."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def _batches(seed: int = 0):
    """Three global batches of the micro CLM: none padded, left pads of
    different lengths, then ``-100`` labels that give the ranks different
    counts of valid tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        t = rng.integers(0, MICRO["vocab_size"], size=(GLOBAL_BATCH, MICRO["max_seq_len"] + 1))
        pad = np.zeros((GLOBAL_BATCH, MICRO["max_seq_len"]), bool)
        labels = t[:, 1:].copy()
        if i == 1:
            pad[1, :7] = True
            pad[2, :30] = True
        if i == 2:
            labels[0, -LAT:-3] = -100
            pad[3, :2] = True
        out.append({"input_ids": t[:, :-1], "labels": labels, "pad_mask": pad})
    return out


def _port_model(weights):
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in weights.items() if k.startswith("w/")},
                          strict=True)
    return model


def _optimizer(name: str):
    from perceiver_io_tpu_torch.training import make_optimizer

    return make_optimizer(1e-3, optimizer=name, gradient_clip=CLIP)


def _fit_config(d, steps, tag):
    from perceiver_io_tpu_torch.training import TrainerConfig

    return TrainerConfig(max_steps=steps, log_interval=1, val_interval=2, checkpoint_dir=os.path.join(d, f"ckpt_{tag}"),
                         max_checkpoints=2)


def _fit(weights, d, tag, mesh=None, steps=4, resume=False):
    """A micro CLM fit over ``_batches`` (its val batch the first), its
    metrics in ``<d>/logs_<tag>``; returns the state."""
    from perceiver_io_tpu_torch.training import MetricsLogger, TrainState, Trainer, clm_loss_fn

    state = TrainState.create(_port_model(weights), _optimizer("adamw"), generator=torch.Generator().manual_seed(0))
    trainer = Trainer(clm_loss_fn(LAT), mesh=mesh, config=_fit_config(d, steps, tag),
                      logger=MetricsLogger(os.path.join(d, f"logs_{tag}"), use_tensorboard=False))
    batches = _batches(1) + _batches(2)
    try:
        return trainer.fit(state, iter(batches), val_loader=batches[:1], resume=resume)
    finally:
        trainer.close()
        trainer.logger.close()


def _rows(path):
    with open(os.path.join(path, "metrics.csv")) as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _raises(fn, exc, text: str) -> bool:
    try:
        fn()
    except exc as e:
        return text in str(e)
    return False


def _train_world(rank, world, d, ref, out):
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.long_context import make_ring_clm_loss
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from perceiver_io_tpu_torch.training import TrainState, clm_loss_fn, make_train_step, shard_train_state

    batches = _batches()
    for name, (axes, opt) in CONFIGS.items():
        mesh = make_mesh(device="cpu", **axes)
        state = shard_train_state(TrainState.create(_port_model(ref), _optimizer(opt)), mesh, min_weight_size=0)
        loss_fn = (make_ring_clm_loss(state.model, mesh, max_latents=LAT) if "seq" in axes
                   else clm_loss_fn(LAT))
        step = make_train_step(lambda m, b, g, f=loss_fn: f(m, b, g, deterministic=True))
        losses = []
        for batch in batches:
            state, metrics = step(state, shard_batch(batch, mesh))
            losses.append(float(metrics["loss"]))
        out[f"{name}/losses"] = np.asarray(losses)
        for pname, p in state.model.named_parameters():
            out[f"{name}/p/{pname}"] = p.full_tensor().detach().numpy()
        if name == "fsdp":
            out["fsdp/dims"] = np.asarray([p.placements[-1].dim for p in state.model.parameters()])
            # placing twice on the same mesh is free; on another mesh the
            # state is re-placed with its values (the elastic reshard)
            opt_before = state.optimizer
            out["idempotent"] = np.array(shard_train_state(state, mesh) is state and state.optimizer is opt_before)
            other = make_mesh(data=2, fsdp=2, device="cpu")
            before = [p.full_tensor() for p in state.model.parameters()]
            moved = shard_train_state(state, other)
            out["replaced"] = np.array(moved.mesh is other and moved.optimizer is not opt_before and all(
                torch.equal(a, p.full_tensor()) for a, p in zip(before, moved.model.parameters())))
    # each batch block draws from its own generator; a block's seq line alike
    from perceiver_io_tpu_torch.training.loop import block_generator

    mesh = make_mesh(data=2, seq=2, device="cpu")
    st = TrainState(model=None, optimizer=None, generator=torch.Generator().manual_seed(3), mesh=mesh)
    draws = torch.cat([torch.rand(4, generator=block_generator(st)) for _ in range(2)])
    gathered = [torch.empty_like(draws) for _ in range(world)]
    dist.all_gather(gathered, draws)
    states = [torch.empty_like(st.generator.get_state()) for _ in range(world)]
    dist.all_gather(states, st.generator.get_state())
    out["block_draws"] = torch.stack(gathered).numpy()  # rank r = (data r // 2, seq r % 2)
    out["block_states_equal"] = np.array(all(torch.equal(s, states[0]) for s in states))
    mesh = make_mesh(data=1, fsdp=world, device="cpu")
    out["mesh_errors"] = np.array([
        _raises(lambda: make_mesh(data=3, device="cpu"), ValueError, "!= 4 devices"),
        _raises(lambda: make_mesh(fsdp=3, device="cpu"), ValueError, "not divisible"),
        _raises(lambda: make_mesh(data=1, tensor=2, seq=2, device="cpu"), NotImplementedError, "A12 part 2, slice 2"),
        _raises(lambda: shard_batch({"x": np.zeros((6, 2))}, mesh), ValueError, "['x']: leading dim 6"),
    ])
    dist.barrier()


def _trainer_world(rank, world, d, ref, out, mesh):
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh
    from perceiver_io_tpu_torch.training import CheckpointManager, TrainState, shard_train_state

    _fit(ref, d, "two", mesh=mesh, steps=2)
    state = _fit(ref, d, "two", mesh=mesh, steps=4, resume="auto")
    out["step"] = np.array(state.step)
    for pname, p in state.model.named_parameters():
        out[f"p/{pname}"] = p.full_tensor().detach().numpy()
    # the checkpoint restores onto a mesh of another shape
    other = make_mesh(data=world, device="cpu")
    fresh = shard_train_state(TrainState.create(_port_model(ref), _optimizer("adamw")), other)
    manager = CheckpointManager(os.path.join(d, "ckpt_two"), monitor=None)
    manager.sync = torch.distributed.barrier
    restored = manager.restore(fresh)
    out["restored_other_mesh"] = np.array(restored.step == 4 and all(
        torch.equal(a.full_tensor(), b.full_tensor()) for a, b in zip(restored.model.parameters(),
                                                                      state.model.parameters())))
    manager.close()


def _cli_world(rank, world, d):
    from perceiver_io_tpu_torch.scripts.text import clm

    corpus = os.path.join(d, "train.txt")
    argv = [*CLI_ARGV, f"--data.train_file={corpus}", f"--data.cache_dir={os.path.join(d, 'cache')}",
            f"--trainer.default_root_dir={os.path.join(d, 'cli')}"]
    runs = (("dp", 2, "false"), ("fsdp", 2, "false"), ("fsdp", 3, "auto"), ("seq", 2, "false"),
            ("ring", 2, "false"))
    for strategy, steps, resume in runs:
        state, _ = clm.main(["fit", *argv, f"--trainer.strategy={strategy}", f"--trainer.max_steps={steps}",
                             f"--trainer.val_interval={steps}", f"--trainer.resume={resume}",
                             f"--trainer.name={strategy}"])
        assert state.step == steps and (state.mesh is None) == (strategy == "dp" and world == 1)


def _worker(scenario: str, rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(1)
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    out = {}
    if scenario == "four":
        pdist.initialize("cpu", rank, world, store=dist.FileStore(os.path.join(d, "store_four"), world))
        _train_world(rank, world, d, ref, out)
    else:
        from perceiver_io_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data=1, fsdp=world, device="cpu")  # joins torchrun's group, never one of its own
        assert dist.get_world_size() == world and dist.get_backend() == "gloo"
        assert not pdist.maybe_initialize_distributed("cpu")  # a second call is a no-op
        _trainer_world(rank, world, d, ref, out, mesh)
        _cli_world(rank, world, d)
    if rank == 0:
        np.savez(os.path.join(d, f"{scenario}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax

    from perceiver_io_tpu.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu.training import TrainState as JaxTrainState
    from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
    from perceiver_io_tpu.training import make_optimizer as jax_make_optimizer
    from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
    from perceiver_io_tpu_torch.convert import state_dict_from_jax

    d = str(tmp_path_factory.mktemp("dist_train"))
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write(CORPUS)
    jm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO))
    batches = _batches()
    init = jax.jit(jm.init, static_argnames="prefix_len")  # eager init costs ~4x the compile
    params = init(jax.random.PRNGKey(0), batches[0]["input_ids"], prefix_len=MICRO["max_seq_len"] - LAT)
    weights = {f"w/{k}": v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, params)).items()}
    np.savez(os.path.join(d, "ref.npz"), **weights)
    procs = _spawn("four", 4, d) + _spawn("two", 2, d, port=_free_port())

    step = jax.jit(jax_make_train_step(jax_clm_loss_fn(jm.apply, max_latents=LAT, deterministic=True), jit=False))

    def jax_steps(opt, steps):
        state = JaxTrainState.create(jm.apply, params, jax_make_optimizer(1e-3, optimizer=opt, gradient_clip=CLIP),
                                     jax.random.PRNGKey(1))
        losses = []
        for batch in steps:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        return np.asarray(losses), {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree.map(np.asarray, state.params)).items()}

    want = {opt: jax_steps(opt, batches) for opt in ("adamw", "lamb")}
    # the 1-process fit the 2-rank fit and resume must reproduce, and JAX's
    # step over the fit's four batches
    one = _fit(weights, d, "one", steps=4)
    want["fit"] = {n: p.detach().numpy() for n, p in one.model.named_parameters()}
    want["fit_jax"] = jax_steps("adamw", (_batches(1) + _batches(2))[:4])
    _join(procs)
    got = {s: dict(np.load(os.path.join(d, f"{s}.npz"))) for s in ("four", "two")}
    return want, got, d


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_train_steps_match_jax_unsharded_step(worlds, name):
    want, got, _ = worlds
    losses, params = want[CONFIGS[name][1]]
    np.testing.assert_allclose(got["four"][f"{name}/losses"], losses, rtol=LOSS_RTOL)
    for pname, p in params.items():
        np.testing.assert_allclose(got["four"][f"{name}/p/{pname}"], p, atol=PARAM_ATOL, rtol=0, err_msg=pname)


def test_fsdp_state_places_jax_dims_once_and_refuses_another_mesh(worlds):
    _, got, _ = worlds
    four = got["four"]
    assert 1 in four["fsdp/dims"] and 0 in four["fsdp/dims"]  # both dims of the Linear weights occur
    assert bool(four["idempotent"]) and bool(four["replaced"])
    assert four["mesh_errors"].tolist() == [True] * 4


def test_batch_blocks_draw_apart_and_a_seq_line_alike(worlds):
    _, got, _ = worlds
    draws = got["four"]["block_draws"]  # rank r sits at data r // 2, seq r % 2
    assert np.array_equal(draws[0], draws[1]) and np.array_equal(draws[2], draws[3])
    assert not np.allclose(draws[0], draws[2])
    assert not np.allclose(draws[0][:4], draws[0][4:])  # each step draws anew
    assert bool(got["four"]["block_states_equal"])  # the state's generator advanced alike


def test_trainer_fit_checkpoint_and_resume_on_two_ranks_match_one_process(worlds):
    want, got, d = worlds
    two = got["two"]
    assert int(two["step"]) == 4 and bool(two["restored_other_mesh"])
    for pname, p in want["fit"].items():
        np.testing.assert_allclose(two[f"p/{pname}"], p, atol=PARAM_ATOL, rtol=0, err_msg=pname)
        # the 1-process fit is JAX's step over the same batches
        np.testing.assert_allclose(p, want["fit_jax"][1][pname], atol=PARAM_ATOL, rtol=0, err_msg=pname)
    one, sharded = _rows(os.path.join(d, "logs_one")), _rows(os.path.join(d, "logs_two"))
    for key in ("train_loss", "val_loss"):
        a = [float(r[key]) for r in one if r.get(key)]
        b = [float(r[key]) for r in sharded if r.get(key)]
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(b, a, rtol=LOSS_RTOL)


def test_clm_cli_runs_dp_fsdp_seq_and_ring_as_two_processes(worlds):
    _, _, d = worlds
    losses = {}
    for name in ("dp", "fsdp", "seq", "ring"):
        rows = _rows(os.path.join(d, "cli", name))
        losses[name] = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
        assert losses[name] and all(math.isfinite(v) for v in losses[name])
        assert any(r.get("val_loss") and math.isfinite(float(r["val_loss"])) for r in rows)
    # the fsdp rerun resumed from step 2 on the same mesh and trained to 3
    assert len(losses["fsdp"]) == 3
    # seq takes ring's route: the same losses
    assert losses["seq"] == losses["ring"]


@pytest.mark.parametrize("env", [{"RANK": "0", "WORLD_SIZE": "2"}, {"WORLD_SIZE": "2"}],
                         ids=["rank_without_rendezvous", "world_without_rank"])
def test_make_mesh_never_starts_a_lone_process_under_a_launcher(monkeypatch, env):
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import make_mesh

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises((ValueError, RuntimeError), match="MASTER_ADDR" if "RANK" in env else "WORLD_SIZE=2"):
        make_mesh(device="cpu")
    assert not dist.is_initialized()


def test_overlap_raises_naming_part_2():
    from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, clm_loss_fn

    with pytest.raises(NotImplementedError, match="A12 part 2"):
        Trainer(clm_loss_fn(LAT), config=TrainerConfig(overlap=True))


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
