"""The port's optical flow model and its host processing against the JAX
package's. The model at a micro width whose attention takes the routes of
``deepmind/optical-flow-perceiver``'s: 12 x 16 frame pairs of 27 patch
channels, 13 hidden channels + 4 Fourier bands (a 31-wide adapter: the
encoder's one cross-attention head takes the heads-major route with the
wrapper's zero padding, as 322 does), 16 latents x 32 channels with 2
self-attention layers of 2 heads of 16 (the packed route, as 16 x 32), and a
decoder of one 36-wide head (the heads-major route, as 512) without an
attention residual. The JAX side runs under ``default_flash(True)``, jitted.

Covered: the flow from converted weights; ``return_adapted_input`` (both
encoders' latents and adapted inputs); which kernel route each attention
takes; the weight bridge and ``jax_param_paths``; the parameter count at
368 x 496 against ``jax.eval_shape`` of JAX's ``init``;
``OpticalFlowProcessor`` preprocess, postprocess and ``process`` bit for bit
against JAX's on generated frames (several overlapping patches), and
``process`` through each package's model; ``render_optical_flow`` and the
image preprocessors bit for bit.

Tolerances (f32), at the level of ``tests/test_torch_image.py``'s logits:
flow and latents atol 1e-4, the adapted input (one f32 projection and the
encodings) atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.vision.optical_flow import OpticalFlowProcessor as JaxOpticalFlowProcessor
from perceiver_io_tpu.data.vision.optical_flow import render_optical_flow as jax_render_optical_flow
from perceiver_io_tpu.data.vision.preprocessor import ImageNetPreprocessor as JaxImageNetPreprocessor
from perceiver_io_tpu.data.vision.preprocessor import ImagePreprocessor as JaxImagePreprocessor
from perceiver_io_tpu.models.vision import OpticalFlow as JaxOpticalFlow
from perceiver_io_tpu.models.vision import OpticalFlowConfig as JaxOpticalFlowConfig
from perceiver_io_tpu.models.vision import OpticalFlowDecoderConfig as JaxOpticalFlowDecoderConfig
from perceiver_io_tpu.models.vision import OpticalFlowEncoderConfig as JaxOpticalFlowEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu_torch.convert import jax_param_paths, optical_flow_state_dict_from_jax
from perceiver_io_tpu_torch.core import attention as tattention
from perceiver_io_tpu_torch.data.vision import ImageNetPreprocessor, ImagePreprocessor, OpticalFlowProcessor
from perceiver_io_tpu_torch.data.vision import render_optical_flow
from perceiver_io_tpu_torch.models.vision import OpticalFlow, OpticalFlowConfig, OpticalFlowDecoderConfig
from perceiver_io_tpu_torch.models.vision import OpticalFlowEncoderConfig

SHAPE = (12, 16)
FLOW_ATOL, ADAPTED_ATOL = 1e-4, 1e-5


def _kwargs(shape=SHAPE, micro=True):
    if micro:
        enc = dict(image_shape=shape, num_patch_hidden_channels=13, num_frequency_bands=4,
                   num_cross_attention_heads=1, num_self_attention_heads=2, num_self_attention_layers_per_block=2)
        dec = dict(image_shape=shape, num_cross_attention_heads=1, num_cross_attention_qk_channels=36,
                   num_cross_attention_v_channels=36, cross_attention_residual=False)
        return enc, dec, dict(num_latents=16, num_latent_channels=32)
    # deepmind/optical-flow-perceiver as the JAX package's hf/convert.py maps it
    enc = dict(image_shape=shape, num_cross_attention_heads=1, num_self_attention_heads=16,
               num_self_attention_qk_channels=512, num_self_attention_v_channels=512,
               num_self_attention_layers_per_block=24)
    dec = dict(image_shape=shape, num_cross_attention_heads=1, num_cross_attention_qk_channels=512,
               num_cross_attention_v_channels=512, cross_attention_residual=False)
    return enc, dec, dict(num_latents=2048, num_latent_channels=512)


def _configs(shape=SHAPE, micro=True):
    enc, dec, top = _kwargs(shape, micro)
    return (JaxOpticalFlowConfig(encoder=JaxOpticalFlowEncoderConfig(**enc),
                                 decoder=JaxOpticalFlowDecoderConfig(**dec), **top),
            OpticalFlowConfig(encoder=OpticalFlowEncoderConfig(**enc), decoder=OpticalFlowDecoderConfig(**dec), **top))


def _pairs(b=2, seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=(b, 2) + shape + (27,)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its jitted apply, its params as numpy, the port's model
    with them)."""
    jcfg, tcfg = _configs()
    jm = JaxOpticalFlow(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_pairs())))
    tm = OpticalFlow(tcfg, device="cpu")
    tm.load_state_dict(optical_flow_state_dict_from_jax(params, decoder_residual=False), strict=True)
    return jm, jax.jit(jm.apply), params, tm


def test_flow_matches_jax(models):
    _, apply, params, tm = models
    x = _pairs(seed=1)
    with default_flash(True):
        want = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2,) + SHAPE + (2,)
    np.testing.assert_allclose(got, want, atol=FLOW_ATOL, rtol=0)


def test_return_adapted_input_matches_jax(models):
    """The encoder's ``(latents, adapted input)`` pair; without the flag the
    latents alone, the same."""
    jm, _, params, tm = models
    x = _pairs(seed=2)
    with default_flash(True):
        jl, ja = jax.jit(lambda p, x: jm.apply(p, x, method=lambda m, x: m.encoder(x, return_adapted_input=True)))(
            params, jnp.asarray(x))
    with torch.no_grad():
        tl, ta = tm.encoder(torch.from_numpy(x), return_adapted_input=True)
        alone = tm.encoder(torch.from_numpy(x))
    assert ta.shape == ja.shape == (2, SHAPE[0] * SHAPE[1], 31)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ADAPTED_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FLOW_ATOL, rtol=0)
    assert torch.equal(alone, tl)


def test_routes(models, monkeypatch):
    """Per forward: the heads-major route for the encoder's cross-attention
    (one head of 31) and the decoder's (one of 36), the packed route for
    the two self-attention layers (heads of 16)."""
    tm = models[3]
    calls = []
    for name in ("flash_attention", "flash_attention_packed"):
        fn = getattr(tattention, name)
        monkeypatch.setattr(tattention, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    with torch.no_grad():
        tm(torch.from_numpy(_pairs()))
    assert calls == ["flash_attention"] + ["flash_attention_packed"] * 2 + ["flash_attention"]


def test_weight_bridge(models):
    params, tm = models[2], models[3]
    sd = optical_flow_state_dict_from_jax(params, decoder_residual=False)
    assert set(sd) == set(tm.state_dict())
    assert {"0.input_adapter.linear.weight", "0.latent_provider._query", "1.cross_attn.0.q_norm.weight",
            "1.output_adapter.linear.weight"} <= set(sd)
    flat = {"params/" + "/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    paths = jax_param_paths(tm)
    assert set(paths) == set(sd)
    for name, path in paths.items():
        assert flat[path].size == sd[name].numel(), (name, path)


def test_full_size_parameter_count_matches_jax():
    """At 368 x 496: the port's meta model against ``jax.eval_shape`` of the
    JAX model's ``init`` (no memory for either's weights)."""
    jcfg, tcfg = _configs((368, 496), micro=False)
    shapes = jax.eval_shape(JaxOpticalFlow(jcfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 2, 368, 496, 27), jnp.float32))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    model = OpticalFlow(tcfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert model.encoder.input_adapter.num_input_channels == 322


# ---------------------------------------------------------------------------
# the host processing
# ---------------------------------------------------------------------------


def _frames(h=20, w=28, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(2)]


def _processors(**kw):
    return OpticalFlowProcessor(patch_size=SHAPE, patch_min_overlap=4, **kw), JaxOpticalFlowProcessor(
        patch_size=SHAPE, patch_min_overlap=4, **kw)


def test_processor_pre_and_postprocess_equal_jax():
    tp, jp = _processors()
    pair = _frames()
    assert tp.compute_patch_grid_indices((20, 28)) == jp.compute_patch_grid_indices((20, 28))
    # 3 x 3 corners, the last row and column right-aligned onto the second
    # (the reference's grid repeats them)
    assert len(tp.compute_patch_grid_indices((20, 28))) == 9
    got, want = tp.preprocess(pair), jp.preprocess(pair)
    assert got.shape == (9, 2) + SHAPE + (27,) and got.dtype == want.dtype and np.array_equal(got, want)
    preds = np.random.default_rng(3).normal(size=(2, 9) + SHAPE + (2,)).astype(np.float32)
    got, want = tp.postprocess(preds, (20, 28)), jp.postprocess(preds, (20, 28))
    assert got.shape == (2, 20, 28, 2) and np.array_equal(got, want)
    with pytest.raises(ValueError, match="height 10 is below"):
        tp.preprocess([np.zeros((10, 28, 3), np.uint8)] * 2)


def test_process_equals_jax_bit_for_bit():
    """The whole pipeline with one numpy model function on both sides."""
    tp, jp = _processors()
    rng = np.random.default_rng(4)
    proj = rng.normal(size=(2 * 27, 2)).astype(np.float32)

    def model_fn(x):
        return np.einsum("ntyxc,tcf->nyxf", x, proj.reshape(2, 27, 2))

    pairs = [_frames(seed=5), _frames(seed=6), _frames(seed=7)]
    got, want = tp.process(model_fn, pairs, batch_size=2), jp.process(model_fn, pairs, batch_size=2)
    assert got.shape == (3, 20, 28, 2) and np.array_equal(got, want)


def test_process_through_each_packages_model(models):
    _, apply, params, tm = models
    tp, jp = _processors()
    pairs = [_frames(seed=8)]

    def port_fn(x):
        with torch.no_grad():
            return tm(torch.from_numpy(x)).numpy()

    with default_flash(True):
        want = jp.process(lambda x: np.asarray(apply(params, jnp.asarray(x))), pairs, batch_size=4)
    got = tp.process(port_fn, pairs, batch_size=4)
    # the processor scales the model's flow by flow_scale_factor (20)
    np.testing.assert_allclose(got, want, atol=20 * FLOW_ATOL, rtol=0)


def test_render_and_image_preprocessors_equal_jax():
    flow = np.random.default_rng(9).normal(size=(20, 28, 2)).astype(np.float32) * 5
    assert np.array_equal(render_optical_flow(flow), jax_render_optical_flow(flow))
    image = np.random.default_rng(10).integers(0, 256, size=(300, 260, 3), dtype=np.uint8)
    for port, jax_side in ((ImagePreprocessor(size=64, crop_size=48), JaxImagePreprocessor(size=64, crop_size=48)),
                           (ImageNetPreprocessor(), JaxImageNetPreprocessor()),
                           (ImageNetPreprocessor(channels_last=False), JaxImageNetPreprocessor(channels_last=False))):
        got, want = port.preprocess_batch([image, image[:, ::-1]]), jax_side.preprocess_batch([image, image[:, ::-1]])
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OpticalFlow(_configs()[1])
