"""The task models' sharded train steps against the JAX package, on the CPU:
the Perceiver IO image classifier, masked LM and time-series forecaster at
micro width, each with a shared cross-attention layer called twice and a
shared self-attention block called twice a forward (one FSDP2 unit run
forward and backward twice a step), under ``data 2`` and under ``fsdp 2`` on
2 gloo ranks: ``training.loop.shard_train_state`` and ``make_train_step`` for
3 AdamW updates under a clip that engages, against JAX's unsharded step on
the same global batches from the same converted parameters. The metrics are
JAX's global ones: the masked LM's ``num_masked`` the global count, the
classifier's ``acc`` the global mean. The image classifier's one-head
cross-attention takes the split-kv route (``call_with_split_kv``, an entry
point registered with FSDP2) on every call.

Tolerances (``tests/test_torch_dist_train.py``'s): losses ``rtol`` 2e-5,
parameters ``atol`` 5e-5 after three updates.

The ranks are child processes running this file as a script: they import
torch and the port only, set one thread each, meet through a ``FileStore``
under ``tmp_path`` (one world of 2 ranks for each mesh, both running every
model) and exchange numpy files with the parent, which computes the JAX
references.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"data2": {"data": 2}, "fsdp2": {"data": 1, "fsdp": 2}}
GLOBAL_BATCH, STEPS, CLIP, LR = 4, 3, 0.05, 1e-3
LOSS_RTOL, PARAM_ATOL = 2e-5, 5e-5
WORKER_TIMEOUT_S = 240
# a shared cross-attention layer and a shared self-attention block, each run
# twice a forward
SHARED = dict(num_cross_attention_layers=2, first_cross_attention_layer_shared=True, num_self_attention_blocks=2,
              first_self_attention_block_shared=True)
IMAGE = dict(encoder=dict(image_shape=(8, 8, 3), num_frequency_bands=4, num_cross_attention_heads=1,
                          num_self_attention_heads=2, num_self_attention_layers_per_block=1, **SHARED),
             decoder=dict(num_classes=4, num_output_query_channels=16, num_cross_attention_heads=1),
             top=dict(num_latents=8, num_latent_channels=16))
MLM_SEQ = 24
MLM = dict(encoder=dict(vocab_size=262, max_seq_len=MLM_SEQ, num_input_channels=16, num_cross_attention_heads=2,
                        num_self_attention_heads=2, num_self_attention_layers_per_block=1, **SHARED),
           decoder=dict(vocab_size=262, max_seq_len=MLM_SEQ, num_cross_attention_heads=2,
                        cross_attention_residual=False),
           top=dict(num_latents=8, num_latent_channels=16))
TS_IN, TS_OUT, TS_CH = 12, 6, 3
TIMESERIES = dict(encoder=dict(num_input_channels=TS_CH, in_len=TS_IN, num_frequency_bands=4, num_cross_attention_heads=1,
                               num_self_attention_heads=2, num_self_attention_layers_per_block=1, **SHARED),
                  decoder=dict(out_len=TS_OUT, num_output_channels=TS_CH, num_cross_attention_heads=1),
                  top=dict(num_latents=8, num_latent_channels=16))
MODELS = ("image", "mlm", "timeseries")


def _batches(name: str):
    """Three global batches of ``name``: the masked LM's with right pads and
    ``-100`` labels that give the ranks different counts of masked tokens."""
    rng = np.random.default_rng({"image": 0, "mlm": 1, "timeseries": 2}[name])
    out = []
    for _ in range(STEPS):
        if name == "image":
            out.append({"image": rng.normal(size=(GLOBAL_BATCH, 8, 8, 3)).astype(np.float32),
                        "label": rng.integers(0, 4, size=GLOBAL_BATCH)})
        elif name == "mlm":
            ids = rng.integers(0, 262, size=(GLOBAL_BATCH, MLM_SEQ)).astype(np.int32)
            labels = np.full(ids.shape, -100, np.int64)
            masked = rng.random(ids.shape) < np.array([0.5, 0.1, 0.3, 0.2])[:, None]
            labels[masked] = ids[masked]
            pad = np.zeros(ids.shape, bool)
            pad[1, 20:], pad[3, 9:] = True, True
            labels[pad] = -100
            out.append({"input_ids": np.where(masked, 3, ids).astype(np.int32), "labels": labels, "pad_mask": pad})
        else:
            out.append({"x": rng.normal(size=(GLOBAL_BATCH, TS_IN, TS_CH)).astype(np.float32),
                        "y": rng.normal(size=(GLOBAL_BATCH, TS_OUT, TS_CH)).astype(np.float32)})
    return out


def _port_model(name: str, weights=None):
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models import text, timeseries, vision

    if name == "image":
        cfg = vision.ImageClassifierConfig(encoder=vision.ImageEncoderConfig(**IMAGE["encoder"]),
                                           decoder=ClassificationDecoderConfig(**IMAGE["decoder"]), **IMAGE["top"])
        model = vision.ImageClassifier(cfg, device="cpu")
    elif name == "mlm":
        cfg = text.MaskedLanguageModelConfig(encoder=text.TextEncoderConfig(**MLM["encoder"]),
                                             decoder=text.TextDecoderConfig(**MLM["decoder"]), **MLM["top"])
        model = text.MaskedLanguageModel(cfg, device="cpu")
    else:
        cfg = timeseries.TimeSeriesPerceiverConfig(
            encoder=timeseries.TimeSeriesEncoderConfig(**TIMESERIES["encoder"]),
            decoder=timeseries.TimeSeriesDecoderConfig(**TIMESERIES["decoder"]), **TIMESERIES["top"])
        model = timeseries.TimeSeriesPerceiver(cfg, device="cpu")
    if weights is not None:
        prefix = f"{name}/"
        model.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in weights.items()
                               if k.startswith(prefix)}, strict=True)
    return model


def _port_loss(name: str):
    from perceiver_io_tpu_torch import training as tt

    return {"image": tt.classification_loss_fn, "mlm": tt.masked_lm_loss_fn,
            "timeseries": tt.mse_loss_fn}[name](deterministic=True)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _worker(scenario: str, rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    from perceiver_io_tpu_torch.core.modules import CrossAttention
    from perceiver_io_tpu_torch.parallel import dist as pdist
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from perceiver_io_tpu_torch.training import TrainState, make_optimizer, make_train_step, shard_train_state

    torch.set_num_threads(1)
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    pdist.initialize("cpu", rank, world, store=dist.FileStore(os.path.join(d, f"store_{scenario}"), world))
    mesh = make_mesh(device="cpu", **MESHES[scenario])
    split_calls = []
    split_kv = CrossAttention.split_kv_projection
    CrossAttention.split_kv_projection = lambda self, *a, **k: split_calls.append(1) or split_kv(self, *a, **k)
    out = {}
    for name in MODELS:
        state = shard_train_state(TrainState.create(_port_model(name, ref), make_optimizer(LR, gradient_clip=CLIP)),
                                  mesh, min_weight_size=0)
        step = make_train_step(_port_loss(name))
        split_calls.clear()
        metrics = []
        for batch in _batches(name):
            state, m = step(state, shard_batch(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"{name}/split_calls"] = np.array(len(split_calls))
        for key in metrics[0]:
            out[f"{name}/m/{key}"] = np.array([m[key] for m in metrics])
        for pname, p in state.model.named_parameters():
            out[f"{name}/p/{pname}"] = p.full_tensor().detach().numpy()
    if rank == 0:
        np.savez(os.path.join(d, f"{scenario}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _spawn(scenario: str, world: int, d: str):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PIO_GROUP_TIMEOUT_S="120", OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), d],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]


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


def _jax_models():
    """``{name: (JAX model, its params, loss_fn, converter)}``."""
    import jax
    import jax.numpy as jnp

    from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxClassificationDecoderConfig
    from perceiver_io_tpu.models import text as jtext
    from perceiver_io_tpu.models import timeseries as jts
    from perceiver_io_tpu.models.vision import image_classifier as jimage
    from perceiver_io_tpu.training import losses as jlosses
    from perceiver_io_tpu_torch import convert

    image = jimage.ImageClassifier(jimage.ImageClassifierConfig(
        encoder=jimage.ImageEncoderConfig(**IMAGE["encoder"]),
        decoder=JaxClassificationDecoderConfig(**IMAGE["decoder"]), **IMAGE["top"]))
    mlm = jtext.MaskedLanguageModel(jtext.MaskedLanguageModelConfig(
        encoder=jtext.TextEncoderConfig(**MLM["encoder"]), decoder=jtext.TextDecoderConfig(**MLM["decoder"]),
        **MLM["top"]))
    ts = jts.TimeSeriesPerceiver(jts.TimeSeriesPerceiverConfig(
        encoder=jts.TimeSeriesEncoderConfig(**TIMESERIES["encoder"]),
        decoder=jts.TimeSeriesDecoderConfig(**TIMESERIES["decoder"]), **TIMESERIES["top"]))
    inputs = {"image": _batches("image")[0]["image"], "mlm": _batches("mlm")[0]["input_ids"],
              "timeseries": _batches("timeseries")[0]["x"]}
    out = {}
    for name, jm, loss, conv in (
            ("image", image, jlosses.classification_loss_fn, convert.image_classifier_state_dict_from_jax),
            ("mlm", mlm, jlosses.masked_lm_loss_fn,
             lambda p: convert.mlm_state_dict_from_jax(p, decoder_residual=False)),
            ("timeseries", ts, jlosses.mse_loss_fn, convert.timeseries_state_dict_from_jax)):
        params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(inputs[name])))
        out[name] = (jm, params, loss(jm.apply, deterministic=True), conv)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from perceiver_io_tpu.training import TrainState as JaxTrainState
    from perceiver_io_tpu.training import make_optimizer as jax_make_optimizer
    from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step

    d = str(tmp_path_factory.mktemp("dist_tasks"))
    models = _jax_models()
    weights = {f"{name}/{k}": v.numpy() for name, (_, params, _, conv) in models.items()
               for k, v in conv(params).items()}
    np.savez(os.path.join(d, "ref.npz"), **weights)
    procs = {s: _spawn(s, 2, d) for s in MESHES}
    want = {}
    for name, (jm, params, loss, conv) in models.items():
        state = JaxTrainState.create(jm.apply, params, jax_make_optimizer(LR, gradient_clip=CLIP),
                                     jax.random.PRNGKey(1))
        step = jax.jit(jax_make_train_step(loss, jit=False))
        metrics = []
        for batch in _batches(name):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        want[name] = ({k: np.array([m[k] for m in metrics]) for k in metrics[0]},
                      {k: v.numpy() for k, v in conv(jax.tree.map(np.asarray, state.params)).items()})
    for p in procs.values():
        _join(p)
    return want, {s: dict(np.load(os.path.join(d, f"{s}.npz"))) for s in MESHES}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", MODELS)
def test_task_model_sharded_steps_match_jax_unsharded_step(runs, name, mesh):
    want, got = runs
    metrics, params = want[name]
    got = got[mesh]
    np.testing.assert_allclose(got[f"{name}/m/loss"], metrics["loss"], rtol=LOSS_RTOL)
    for pname, p in params.items():
        np.testing.assert_allclose(got[f"{name}/p/{pname}"], p, atol=PARAM_ATOL, rtol=0, err_msg=pname)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_task_metrics_are_the_global_batch_ones(runs, mesh):
    """The masked LM's ``num_masked`` is the global count (the ranks' blocks
    hold different counts), the classifier's ``acc`` the global mean."""
    want, got = runs
    got = got[mesh]
    assert sorted(k.split("/")[-1] for k in got if k.startswith("mlm/m/")) == sorted(want["mlm"][0])
    np.testing.assert_array_equal(got["mlm/m/num_masked"], want["mlm"][0]["num_masked"])
    assert (want["mlm"][0]["num_masked"] > 0).all()
    np.testing.assert_array_equal(got["image/m/acc"], want["image"][0]["acc"])


def test_split_kv_route_runs_through_its_registered_method(runs):
    """The classifier's shared one-head cross-attention took the split-kv
    route at each of its two calls in each of the three steps (FSDP2 gathers
    its unit there through ``register_fsdp_forward_method``); the other
    models' wider heads never do."""
    _, got = runs
    for mesh in MESHES:
        assert int(got[mesh]["image/split_calls"]) == 2 * STEPS
        assert int(got[mesh]["mlm/split_calls"]) == int(got[mesh]["timeseries/split_calls"]) == 0


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
