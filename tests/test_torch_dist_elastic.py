"""The port's elastic resume against the JAX package, on the CPU: a micro CLM
state (JAX's parameters and Adam moments after two updates, converted) saved
under ``fsdp 2`` on 2 gloo ranks, restored with
``CheckpointManager.restore(mesh=...)`` on ``data 2 x fsdp 2`` (4 ranks)
and on one process without a mesh, against JAX's ``restore(mesh=...)`` of
the same state saved on an ``fsdp 2`` mesh of the forced CPU devices: the
parameters and moments bit for bit (the payload is whole tensors), and the
``resume.reshard`` event's step, mesh change and meshes equal to JAX's,
its leaves and bytes moved over the parameters and moments equal to JAX's.
Also ``shard_train_state`` re-placing a state from one mesh onto another,
``preflight`` treating the change of mesh as no error, and JAX's
``test_trainer_resumes_across_meshes_with_matching_trajectory``: a fit of 4
steps on ``fsdp 2`` (2 ranks) resumed with ``resume="auto"`` on
``data 2 x fsdp 2`` (4 ranks) to 8, its losses within 1e-6 relative of an
uninterrupted fit, the reshard event inside the ``resume`` span.

Differences of contract (ROADMAP §C): the process counts are the worlds'
(2, then 4 or 1; the port runs one process per device, where JAX's CPU
reference is one process holding every device); the leaves besides the
parameters and moments (AdamW's per-parameter step counts against optax's
count, the generator's state against JAX's key) have no common count; the
event's ``path`` is ``"host_gather"`` (every restore reads whole tensors).

The ranks are child processes running this file as a script (the 2-rank
world first, then the 4-rank one): they import torch and the port only, set
one thread each, meet through a ``FileStore`` and exchange numpy files with
the parent, which computes the JAX references and restores onto one
process.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(vocab_size=64, max_seq_len=64, max_latents=16, num_channels=32, num_heads=4,
             num_self_attention_layers=2, cross_attention_dropout=0.0)
LAT = MICRO["max_latents"]
SAVED_STEP, FIT_STEPS, RESUME_AT = 2, 8, 4
TRAJECTORY_RTOL = 1e-6
WORKER_TIMEOUT_S = 240
MESH_A, MESH_B = {"data": 1, "fsdp": 2}, {"data": 2, "fsdp": 2}


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, MICRO["vocab_size"], size=(4, MICRO["max_seq_len"] + 1))
        out.append({"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None})
    return out


class Sink:
    """An ``emit()`` sink keeping the rows."""

    def __init__(self):
        self.rows = []

    def emit(self, kind, **fields):
        self.rows.append((kind, fields))

    def of(self, kind):
        return [f for k, f in self.rows if k == kind]


def _port_state(ref, with_moments: bool):
    """The micro CLM's state from JAX's converted parameters; with
    ``with_moments`` JAX's moments and update count after two updates."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.training import TrainState, make_optimizer

    model = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in ref.items() if k.startswith("w/")}, strict=True)
    state = TrainState.create(model, make_optimizer(1e-3), generator=torch.Generator().manual_seed(0))
    if with_moments:
        adamw, count = state.optimizer.adamw, int(ref["count"])
        with torch.no_grad():
            for name, p in model.named_parameters():
                s = adamw.state[p]
                s["exp_avg"].copy_(torch.from_numpy(ref[f"mu/{name}"]))
                s["exp_avg_sq"].copy_(torch.from_numpy(ref[f"nu/{name}"]))
                s["step"].fill_(count)
            state.optimizer.count.fill_(count)
        state.step = SAVED_STEP
    return state


def _whole(state) -> dict:
    """The state's parameters and Adam moments, whole (a collective on a
    sharded state), by the port's names."""
    from perceiver_io_tpu_torch.parallel.mesh import gather_full

    out = {}
    adamw = state.optimizer.adamw
    sharded = state.mesh is not None
    for (name, p), local in zip(state.model.named_parameters(), state.optimizer.params):
        out[f"w/{name}"] = (p.full_tensor() if sharded else p).detach().numpy()
        for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = adamw.state[local][moment]
            out[f"{key}/{name}"] = (gather_full(t, p) if sharded else t).detach().numpy()
    return out


def _kind_diff(saved: dict, target: dict) -> dict:
    """The reshard diff over the parameters and moments alone."""
    from perceiver_io_tpu_torch.training.checkpoint import diff_fingerprints_for_reshard

    def keep(fp):
        return {**fp, "leaves": {k: v for k, v in fp["leaves"].items() if v["kind"] in ("param", "moment")}}

    return diff_fingerprints_for_reshard(keep(saved), keep(target))


def _event_record(prefix: str, event: dict, kinds: dict) -> dict:
    return {f"{prefix}/event": json.dumps(event), f"{prefix}/kinds": json.dumps(kinds)}


def _trainer(d: str, name: str, mesh, max_steps: int, losses: list):
    from perceiver_io_tpu_torch.training import MetricsLogger, Trainer, TrainerConfig, clm_loss_fn

    cfg = TrainerConfig(max_steps=max_steps, log_interval=1, val_interval=RESUME_AT, max_checkpoints=2,
                        checkpoint_dir=os.path.join(d, name, "ckpt"), fsdp_min_weight_size=0)
    trainer = Trainer(clm_loss_fn(LAT), mesh=mesh, config=cfg,
                      logger=MetricsLogger(os.path.join(d, name, "logs"), use_tensorboard=False))
    step = trainer._train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer._train_step = recorded
    return trainer


def _fit(d, name, mesh, ref, max_steps, resume=False):
    losses = []
    trainer = _trainer(d, name, mesh, max_steps, losses)
    batches = _batches(FIT_STEPS, seed=3)
    try:
        state = trainer.fit(_port_state(ref, False), iter(batches), val_loader=batches[:1], resume=resume)
    finally:
        trainer.close()
        trainer.logger.close()
    return state, losses


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _two(rank, d, ref, out):
    """Save the state under fsdp 2; fit 8 steps, and 4 of another run."""
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh
    from perceiver_io_tpu_torch.training import CheckpointManager, shard_train_state

    mesh = make_mesh(device="cpu", **MESH_A)
    state = shard_train_state(_port_state(ref, True), mesh, min_weight_size=0)
    manager = CheckpointManager(os.path.join(d, "ckpt"), monitor=None)
    manager.save(state)
    manager.close()
    _, out["ref_losses"] = _fit(d, "ref", mesh, ref, FIT_STEPS)
    _, out["run_losses"] = _fit(d, "run", mesh, ref, RESUME_AT)


def _four(rank, d, ref, out):
    """Restore onto data 2 x fsdp 2; re-place a state; resume the fit."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from perceiver_io_tpu_torch.training import CheckpointManager, shard_train_state, sharding_fingerprint

    mesh = make_mesh(device="cpu", **MESH_B)
    sink = Sink()
    manager = CheckpointManager(os.path.join(d, "ckpt"), monitor=None, event_sink=sink)
    manager.sync = dist.barrier
    info = manager.preflight(_port_state(ref, False))
    state = manager.restore(_port_state(ref, False), mesh=mesh, min_weight_size=0)
    out.update({f"restored/{k}": v for k, v in _whole(state).items()})
    out["restored_step"] = np.array(state.step)
    out.update(_event_record("four", sink.of("resume.reshard"), _kind_diff(
        manager.step_fingerprint(SAVED_STEP), sharding_fingerprint(state))))
    out["preflight"] = np.array(json.dumps(info))
    manager.close()
    # a step saved on the mesh the state lies on restores with nothing moved
    again = Sink()
    same = CheckpointManager(os.path.join(d, "ckpt_same"), monitor=None, event_sink=again)
    same.sync = dist.barrier
    same.save(state)
    same.restore(state)
    out["same_mesh_events"] = np.array(len(again.of("resume.reshard")))
    same.close()
    # re-placing: fsdp 4, then data 2 x fsdp 2, the values kept
    other = make_mesh(data=1, fsdp=4, device="cpu")
    placed = shard_train_state(_port_state(ref, True), other, min_weight_size=0)
    before = _whole(placed)
    placed = shard_train_state(placed, mesh, min_weight_size=0)
    after = _whole(placed)
    out["replaced_equal"] = np.array(all(np.array_equal(before[k], after[k]) for k in before))
    p = next(placed.model.parameters())
    out["replaced_mesh"] = np.array(json.dumps(dict(zip(p.device_mesh.mesh_dim_names, p.device_mesh.shape))))
    out["replaced_state_mesh"] = np.array(json.dumps(mesh_shape(placed.mesh)))
    out["replaced_step"] = np.array(placed.step)
    state, out["resumed_losses"] = _fit(d, "run", mesh, ref, FIT_STEPS, resume="auto")
    out["resumed_step"] = np.array(state.step)


def _worker(scenario: str, rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(1)
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    pdist.initialize("cpu", rank, world, store=dist.FileStore(os.path.join(d, f"store_{scenario}"), world))
    out = {}
    {"two": _two, "four": _four}[scenario](rank, d, ref, out)
    if rank == 0:
        np.savez(os.path.join(d, f"{scenario}.npz"), **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _spawn(scenario: str, world: int, d: str):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PIO_GROUP_TIMEOUT_S="120", OMP_NUM_THREADS="1")
    return scenario, [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), d],
                                       env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(world)]


def _join(world, d: str) -> dict:
    """The ranks' exit, and rank 0's results."""
    scenario, procs = world
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
    return dict(np.load(os.path.join(d, f"{scenario}.npz")))


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` inside ``opt_state``."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _jax_kind_diff(saved: dict, target: dict) -> dict:
    """JAX's reshard diff over the parameters and the Adam moments alone."""
    from perceiver_io_tpu.training.checkpoint import diff_fingerprints_for_reshard

    def keep(fp):
        return {**fp, "leaves": {k: v for k, v in fp["leaves"].items()
                                 if k.startswith("['params']") or re.search(r"\.(mu|nu)\[", k)}}

    return diff_fingerprints_for_reshard(keep(saved), keep(target))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from perceiver_io_tpu.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from perceiver_io_tpu.training import CheckpointManager as JaxCheckpointManager
    from perceiver_io_tpu.training import TrainState as JaxTrainState
    from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
    from perceiver_io_tpu.training import make_optimizer as jax_make_optimizer
    from perceiver_io_tpu.training import sharding_fingerprint as jax_sharding_fingerprint
    from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
    from perceiver_io_tpu.training.loop import shard_train_state as jax_shard_train_state
    from perceiver_io_tpu_torch.convert import state_dict_from_jax
    from perceiver_io_tpu_torch.training import CheckpointManager, sharding_fingerprint

    d = str(tmp_path_factory.mktemp("dist_elastic"))
    jm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO))
    batches = _batches(SAVED_STEP)
    params = jax.tree.map(np.asarray, jax.jit(jm.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(0), batches[0]["input_ids"], prefix_len=MICRO["max_seq_len"] - LAT))

    def fresh():
        return JaxTrainState.create(jm.apply, params, jax_make_optimizer(1e-3), jax.random.PRNGKey(1))

    step = jax.jit(jax_make_train_step(jax_clm_loss_fn(jm.apply, max_latents=LAT, deterministic=True), jit=False))
    state = fresh()
    for batch in batches:
        state, _ = step(state, batch)
    adam = _adam_state(state.opt_state)

    def port_names(tree, key):
        return {f"{key}/{k}": v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, tree)).items()}

    ref = {**port_names(state.params, "w"), **port_names(adam.mu, "mu"), **port_names(adam.nu, "nu"),
           "count": np.array(int(adam.count))}
    np.savez(os.path.join(d, "ref.npz"), **ref)
    two = _spawn("two", 2, d)  # the 4-rank world restores what this one saves
    # JAX, meanwhile: the same state saved on an fsdp 2 mesh, restored onto data 2 x
    # fsdp 2 and onto one device
    devices = jax.devices()
    saved = jax_shard_train_state(state, jax_make_mesh(data=1, fsdp=2, devices=devices[:2]), min_weight_size=0)
    manager = JaxCheckpointManager(os.path.join(d, "jax_ckpt"), monitor=None)
    manager.save(saved)
    manager.close()
    want = {}
    for key, mesh in (("four", jax_make_mesh(data=2, fsdp=2, devices=devices[:4])), ("one", None)):
        sink = Sink()
        m = JaxCheckpointManager(os.path.join(d, "jax_ckpt"), monitor=None, event_sink=sink)
        # the flat target: every leaf committed to one device (numpy leaves
        # would make orbax read the saved mesh's sharding file)
        target = fresh() if mesh is not None else jax.device_put(fresh(), devices[0])
        restored = m.restore(target, mesh=mesh, min_weight_size=0)
        fp = jax_sharding_fingerprint({"step": restored.step, "params": restored.params, "rng": restored.rng,
                                       "opt_state": restored.opt_state})
        want[key] = {"event": sink.of("resume.reshard"), "kinds": _jax_kind_diff(m.step_fingerprint(SAVED_STEP), fp),
                     "values": {**port_names(restored.params, "w"),
                                **port_names(_adam_state(restored.opt_state).mu, "mu"),
                                **port_names(_adam_state(restored.opt_state).nu, "nu")},
                     "step": int(restored.step)}
        m.close()
    got = {"two": _join(two, d)}
    # the port on one process, no mesh
    sink = Sink()
    port = CheckpointManager(os.path.join(d, "ckpt"), monitor=None, event_sink=sink)
    one = port.restore(_port_state(ref, False))
    got["one"] = {**{f"restored/{k}": v for k, v in _whole(one).items()}, "restored_step": np.array(one.step),
                  **_event_record("one", sink.of("resume.reshard"), _kind_diff(
                      port.step_fingerprint(SAVED_STEP), sharding_fingerprint(one)))}
    port.close()
    got["four"] = _join(_spawn("four", 4, d), d)
    return ref, want, got, d


@pytest.mark.parametrize("target", ["four", "one"])
def test_restore_across_meshes_equals_jax_restore_bit_for_bit(runs, target):
    ref, want, got, _ = runs
    got = got[target]
    assert int(got["restored_step"]) == want[target]["step"] == SAVED_STEP
    for key, value in want[target]["values"].items():
        np.testing.assert_array_equal(got[f"restored/{key}"], value, err_msg=key)
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    assert sorted(k[len("restored/"):] for k in got if k.startswith("restored/")) == sorted(want[target]["values"])


@pytest.mark.parametrize("target", ["four", "one"])
def test_reshard_event_carries_jax_fields(runs, target):
    _, want, got, _ = runs
    (event,), (jevent,) = json.loads(str(got[target][f"{target}/event"])), want[target]["event"]
    assert sorted(event) == sorted(jevent)  # JAX's keys
    for key in ("step", "mesh_changed", "old_mesh", "new_mesh"):
        assert event[key] == jevent[key], key
    assert event["mesh_changed"] is True and event["old_mesh"] == {"data": 1, "fsdp": 2, "tensor": 1, "seq": 1}
    # over the parameters and moments, what moved is what JAX moved
    kinds, jkinds = json.loads(str(got[target][f"{target}/kinds"])), want[target]["kinds"]
    assert (kinds["leaves_resharded"], kinds["bytes_moved"]) == (jkinds["leaves_resharded"], jkinds["bytes_moved"])
    assert kinds["leaves_resharded"] > 0
    assert event["leaves_resharded"] >= kinds["leaves_resharded"] and event["bytes_moved"] >= kinds["bytes_moved"]
    # the process counts are the worlds' (JAX's reference is one process)
    assert (event["old_process_count"], event["new_process_count"]) == (2, 4 if target == "four" else 1)
    assert jevent["old_process_count"] == jevent["new_process_count"] == 1
    assert event["path"] == "host_gather" and event["wall_s"] >= 0


def test_replacing_and_same_mesh_restore(runs):
    """``shard_train_state`` re-places a state from ``fsdp 4`` onto
    ``data 2 x fsdp 2`` with its values; a step saved on the mesh the state
    lies on restores without an event; preflight reports the change of mesh
    as a reshard, not an error."""
    _, _, got, _ = runs
    four = got["four"]
    assert bool(four["replaced_equal"]) and int(four["replaced_step"]) == SAVED_STEP
    assert json.loads(str(four["replaced_mesh"])) == {"data": 2, "fsdp": 2}
    assert json.loads(str(four["replaced_state_mesh"])) == {"data": 2, "fsdp": 2, "tensor": 1, "seq": 1}
    assert int(four["same_mesh_events"]) == 0
    info = json.loads(str(four["preflight"]))
    assert info["reshard"] is True and info["step"] == SAVED_STEP
    assert info["old_mesh"]["fsdp"] == 2 and info["new_mesh"] is None  # the fresh state lay on no mesh


def test_trainer_resumes_across_meshes_with_matching_trajectory(runs):
    _, _, got, d = runs
    ref_losses = got["two"]["ref_losses"].tolist()
    joined = got["two"]["run_losses"].tolist() + got["four"]["resumed_losses"].tolist()
    assert int(got["four"]["resumed_step"]) == FIT_STEPS and len(ref_losses) == len(joined) == FIT_STEPS
    worst = max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(ref_losses, joined))
    assert worst <= TRAJECTORY_RTOL, worst
    with open(os.path.join(d, "run", "logs", "events-p0.jsonl")) as f:  # process 0's stream
        rows = [json.loads(line) for line in f if line.strip()]
    reshard = [r for r in rows if r.get("event") == "resume.reshard"]
    assert reshard and reshard[0]["old_mesh"]["data"] == 1 and reshard[0]["new_mesh"]["data"] == 2
    spans = {r["span_id"]: r["name"] for r in rows if r.get("event") == "span"}
    assert spans.get(reshard[0].get("span_id")) == "resume"
    resumed = [r for r in rows if r.get("event") == "resume"]
    assert resumed and resumed[0]["to_step"] == RESUME_AT


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
