"""The port's time-series forecaster and its CSV data module against the JAX
package's. The model at a micro width whose attention takes the routes of
``scripts/timeseries.py``'s defaults (one head of 256 in every attention: the
heads-major route): 3 channels, 24 input and 10 output steps, 4 Fourier
bands, 8 latents x 20 channels (one head of 20 everywhere: the heads-major
route), 2 weight-shared one-layer self-attention blocks. The JAX side runs
under ``default_flash(True)``, jitted.

Covered: the forecast; which kernel route each attention takes; the
``mse_loss_fn`` gradient tree; one AdamW step in two microbatch chunks
against the one-chunk step; the weight bridge and
``jax_param_paths``; ``read_csv_columns``, ``SlidingWindowDataset`` and
``CSVDataModule``'s train, validation and test batches equal to JAX's on a
CSV written by the test.

Tolerances (f32), at the levels of ``tests/test_torch_image.py`` and
``tests/test_torch_image_train.py``: forecasts atol 1e-4; the loss within
4e-6; gradients per parameter, max abs difference over the JAX gradient's
max abs value <= 4e-6 (key-projection biases within 1e-10 of 0 on both
sides); parameters after the two-chunk step within atol 1e-5 of the
one-chunk step's (see ``tests/test_torch_text_classifier.py`` on Adam's first
step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.timeseries import CSVDataModule as JaxCSVDataModule
from perceiver_io_tpu.data.timeseries import SlidingWindowDataset as JaxSlidingWindowDataset
from perceiver_io_tpu.data.timeseries import read_csv_columns as jax_read_csv_columns
from perceiver_io_tpu.models.timeseries import TimeSeriesDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.models.timeseries import TimeSeriesEncoderConfig as JaxEncoderConfig
from perceiver_io_tpu.models.timeseries import TimeSeriesPerceiver as JaxTimeSeriesPerceiver
from perceiver_io_tpu.models.timeseries import TimeSeriesPerceiverConfig as JaxConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.training import mse_loss_fn as jax_mse_loss_fn
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import jax_param_paths, timeseries_state_dict_from_jax
from perceiver_io_tpu_torch.core import attention as tattention
from perceiver_io_tpu_torch.data.timeseries import CSVDataModule, SlidingWindowDataset, read_csv_columns
from perceiver_io_tpu_torch.models.timeseries import (
    TimeSeriesDecoderConfig,
    TimeSeriesEncoderConfig,
    TimeSeriesPerceiver,
    TimeSeriesPerceiverConfig,
)

IN_LEN, OUT_LEN, CH = 24, 10, 3
OUT_ATOL, LOSS_ATOL, GRAD_RTOL, ZERO_GRAD_ATOL, PARAM_ATOL = 1e-4, 4e-6, 4e-6, 1e-10, 1e-5
ENCODER = dict(num_input_channels=CH, in_len=IN_LEN, num_frequency_bands=4, num_cross_attention_heads=1,
               num_self_attention_heads=1, num_self_attention_layers_per_block=1, num_self_attention_blocks=2)
DECODER = dict(out_len=OUT_LEN, num_output_channels=CH, num_cross_attention_heads=1)
TOP = dict(num_latents=8, num_latent_channels=20)


def _config():
    return TimeSeriesPerceiverConfig(encoder=TimeSeriesEncoderConfig(**ENCODER),
                                     decoder=TimeSeriesDecoderConfig(**DECODER), **TOP)


def _series(b=4, seed=0, n=IN_LEN):
    return np.random.default_rng(seed).normal(size=(b, n, CH)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its jitted apply, its params as numpy, the port's model
    with them)."""
    jm = JaxTimeSeriesPerceiver(JaxConfig(encoder=JaxEncoderConfig(**ENCODER), decoder=JaxDecoderConfig(**DECODER),
                                          **TOP))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_series())))
    tm = TimeSeriesPerceiver(_config(), device="cpu")
    tm.load_state_dict(timeseries_state_dict_from_jax(params), strict=True)
    return jm, jax.jit(jm.apply), params, tm


def test_forecast_matches_jax(models):
    _, apply, params, tm = models
    x = _series(seed=1)
    with default_flash(True):
        want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, OUT_LEN, CH)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0)


def test_routes(models, monkeypatch):
    """Per forward: the heads-major route for the encoder's cross-attention,
    the two (shared) self-attention calls and the decoder's cross-attention."""
    tm = models[3]
    calls = []
    for name in ("flash_attention", "flash_attention_packed"):
        fn = getattr(tattention, name)
        monkeypatch.setattr(tattention, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    with torch.no_grad():
        tm(torch.from_numpy(_series()))
    assert calls == ["flash_attention"] * 4


def test_weight_bridge(models):
    params, tm = models[2], models[3]
    sd = timeseries_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert {"encoder.input_adapter.linear.weight", "encoder.input_adapter.pos_proj.weight",
            "encoder.latent_provider._query", "decoder.output_query_provider._query",
            "decoder.output_adapter.linear.bias"} <= set(sd)
    flat = {"params/" + "/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    paths = jax_param_paths(tm)
    assert set(paths) == set(sd)
    for name, path in paths.items():
        assert flat[path].size == sd[name].numel(), (name, path)


def _batch(seed, b=4):
    return {"x": _series(b, seed), "y": _series(b, seed + 100, OUT_LEN)}


def test_mse_gradient_tree_matches_jax(models):
    jm, _, params, tm = models
    batch = _batch(3)
    loss_fn = jax_mse_loss_fn(jm.apply, deterministic=True)
    with default_flash(True):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = timeseries_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm.zero_grad()
    loss, _ = tt.mse_loss_fn(deterministic=True)(tm, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    assert tt.mse_loss_fn().uniform_weighting is True
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w, g = w.numpy(), grads[name].numpy()
        if name.endswith("attention.k_proj.bias"):
            assert np.abs(w).max() <= ZERO_GRAD_ATOL and np.abs(g).max() <= ZERO_GRAD_ATOL, name
            continue
        assert np.abs(g - w).max() / np.abs(w).max() <= GRAD_RTOL, name
    tm.zero_grad()


def test_microbatched_step_equals_one_chunk(models):
    """``uniform_weighting = True``: one AdamW step (clip 1.0) in two
    microbatch chunks moves the weights as the one-chunk step does, and
    both move them."""
    params = models[2]
    moved = []
    for chunks in (1, 2):
        tm = TimeSeriesPerceiver(_config(), device="cpu")
        tm.load_state_dict(timeseries_state_dict_from_jax(params), strict=True)
        state = tt.TrainState.create(tm, tt.make_optimizer(1e-3, gradient_clip=1.0))
        state, metrics = tt.make_train_step(tt.mse_loss_fn(deterministic=True), microbatch=chunks)(state, _batch(10))
        moved.append((float(metrics["loss"]), {n: p.detach().clone() for n, p in tm.named_parameters()}))
    assert abs(moved[0][0] - moved[1][0]) < LOSS_ATOL
    init = timeseries_state_dict_from_jax(params)
    assert max(float((moved[0][1][n] - init[n]).abs().max()) for n in init) > 1e-4
    for name, p in moved[0][1].items():
        torch.testing.assert_close(moved[1][1][name], p, atol=PARAM_ATOL, rtol=0, msg=name)


def _write_csv(path, rows, seed):
    rng = np.random.default_rng(seed)
    body = np.concatenate([np.arange(rows)[:, None], rng.normal(size=(rows, 7))], axis=1)
    np.savetxt(path, body, delimiter=",", header="date," + ",".join(f"c{i}" for i in range(7)), comments="",
               fmt="%.6f")
    return str(path)


def test_csv_windows_match_jax(tmp_path):
    paths = {split: _write_csv(tmp_path / f"{split}.csv", rows, seed)
             for split, rows, seed in (("train", 230, 1), ("val", 120, 2), ("test", 97, 3))}
    kwargs = dict(train_path=paths["train"], val_path=paths["val"], test_path=paths["test"], in_len=40,
                  out_len=25, stride=16, batch_size=3, seed=5)
    port, jax_side = CSVDataModule(**kwargs), JaxCSVDataModule(**kwargs)
    assert port.num_channels == jax_side.num_channels == 7
    for name in ("train_batches", "valid_batches", "test_batches"):
        got, want = list(getattr(port, name)()), list(getattr(jax_side, name)())
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"x", "y"}
            assert all(g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]) for k in g), name
    data = read_csv_columns(paths["train"], usecols=(1, 3))
    assert np.array_equal(data, jax_read_csv_columns(paths["train"], usecols=(1, 3))) and data.shape == (230, 2)
    ds, jds = SlidingWindowDataset(data, 30, 20, 50), JaxSlidingWindowDataset(data, 30, 20, 50)
    assert len(ds) == len(jds) == 4
    assert all(np.array_equal(ds[i][k], jds[i][k]) for i in range(4) for k in ("x", "y"))
    with pytest.raises(ValueError, match="too short"):
        SlidingWindowDataset(data, 200, 100)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TimeSeriesPerceiver(_config())
