"""The port's Perceiver IO image classifier against the JAX package's, at a
small size: 16x16x3 images, 128 latents x 32 channels, 2 self-attention
heads, one layer per block and 2 weight-shared blocks, 4 classes. The JAX
side runs under ``default_flash(True)``, so its heads-major and packed
kernels run in Pallas interpret mode and its encoder takes the fused
split-kv route, as ``tests/test_fused_image_input.py`` does.

Covered: the Fourier position encodings (exactly), the split-kv K/V
projection, the logits from converted weights on the split route (8 and 32
frequency bands: split widths 40 and 136, the second over the packed
kernel's 128), with a pad mask (the standard route in both packages) and
with a 3-head cross-attention at 36 qk channels (head dim 12, the
heads-major multi-head route); which route each call takes; the weight
bridge; the device contract. The gradient tree and the train steps are in
``tests/test_torch_image_train.py``.

Tolerances, about four times the largest measured difference or the
issue's bound where that is larger (f32; the port's plain versions sum in
other orders than JAX's interpret-mode kernels):

- logits: atol 1e-4; split-kv K/V: atol 2e-5."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core import modules as jmodules
from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.core.position import FourierPositionEncoding as JaxFourier
from perceiver_io_tpu.core.position import fourier_position_encodings as jax_fourier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu_torch.convert import image_classifier_state_dict_from_jax
from perceiver_io_tpu_torch.core import modules as tmodules
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.core.modules import CrossAttention, split_padded
from perceiver_io_tpu_torch.core.position import FourierPositionEncoding, fourier_position_encodings
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig

IMAGE = (16, 16, 3)
LOGIT_ATOL, KV_ATOL = 1e-4, 2e-5


def _configs(bands=8, ca_heads=1, ca_qk=None):
    enc = dict(image_shape=IMAGE, num_frequency_bands=bands, num_cross_attention_heads=ca_heads,
               num_cross_attention_qk_channels=ca_qk, num_self_attention_heads=2,
               num_self_attention_layers_per_block=1, num_self_attention_blocks=2)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1)
    top = dict(num_latents=128, num_latent_channels=32)
    return (JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc), decoder=JaxDecoderConfig(**dec), **top),
            ImageClassifierConfig(encoder=ImageEncoderConfig(**enc), decoder=ClassificationDecoderConfig(**dec),
                                  **top))


def _images(b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b,) + IMAGE).astype(np.float32)


@pytest.fixture(scope="module", params=[(8, 1, None), (32, 1, None), (8, 3, 36)],
                ids=["split40", "split136", "heads3_d12"])
def models(request):
    """(JAX model, its params as numpy, the port's model with them)."""
    jcfg, tcfg = _configs(*request.param)
    jm = JaxImageClassifier(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(_images())))
    tm = ImageClassifier(tcfg, device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    return jm, params, tm


@contextlib.contextmanager
def count_split_calls():
    """Spy on both packages' fused route, as tests/test_fused_image_input.py
    does: (JAX calls, port calls)."""
    calls = ([], [])
    jorig = jmodules.CrossAttentionLayer.call_with_split_kv
    torig = tmodules.CrossAttentionLayer.call_with_split_kv

    def jspy(self, *a, **kw):
        calls[0].append(1)
        return jorig(self, *a, **kw)

    def tspy(self, *a, **kw):
        calls[1].append(1)
        return torig(self, *a, **kw)

    jmodules.CrossAttentionLayer.call_with_split_kv = jspy
    tmodules.CrossAttentionLayer.call_with_split_kv = tspy
    try:
        yield calls
    finally:
        jmodules.CrossAttentionLayer.call_with_split_kv = jorig
        tmodules.CrossAttentionLayer.call_with_split_kv = torig


def _logits(models, x, pad=None):
    jm, params, tm = models
    with default_flash(True), count_split_calls() as calls:
        want = np.asarray(jm.apply(params, jnp.asarray(x), pad_mask=None if pad is None else jnp.asarray(pad)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), pad_mask=None if pad is None else torch.from_numpy(pad)).numpy()
    return got, want, calls


def test_logits_match_jax(models):
    """The split route for one cross-attention head (both packages' fused
    route ran), the standard heads-major route for three."""
    x = _images()
    got, want, (jcalls, tcalls) = _logits(models, x)
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    split = models[2].encoder.num_cross_attention_heads == 1
    assert (len(jcalls), len(tcalls)) == ((1, 1) if split else (0, 0))


def test_logits_with_a_pad_mask_match_jax(models):
    """A pad mask sends both encoders down the standard route (the joined
    input, kv_norm, the heads-major kernel with a bias row)."""
    x = _images(seed=1)
    pad = np.zeros((2, IMAGE[0] * IMAGE[1]), bool)
    pad[1, :40] = True
    got, want, (jcalls, tcalls) = _logits(models, x, pad)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    assert (len(jcalls), len(tcalls)) == (0, 0)


def test_split_route_equals_the_standard_route(models):
    """The port's own two routes on the same input agree (a pad mask of all
    False takes the standard route)."""
    tm = models[2]
    x = torch.from_numpy(_images(seed=2))
    with torch.no_grad():
        split = tm(x)
        standard = tm(x, pad_mask=torch.zeros(2, IMAGE[0] * IMAGE[1], dtype=torch.bool))
    torch.testing.assert_close(split, standard, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bands", [((16, 16), 8), ((224, 224), 64), ((5, 7, 3), 4)])
def test_fourier_position_encodings_match_jax_exactly(shape, bands):
    got = fourier_position_encodings(shape, bands)
    want = jax_fourier(shape, bands)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert (FourierPositionEncoding(shape, bands).num_position_encoding_channels()
            == JaxFourier(shape, bands).num_position_encoding_channels() == got.shape[1])
    enc = FourierPositionEncoding(shape, bands)(2)
    assert enc.shape == (2,) + got.shape and np.array_equal(enc[1].numpy(), want)


@pytest.mark.parametrize("n_pix,n_enc,qk", [(3, 34, 37), (3, 130, 133), (5, 27, 16)])
def test_split_kv_projection_matches_jax(n_pix, n_enc, qk):
    """K/V of the fused route against JAX's ``split_kv_projection`` from the
    same weights, and against the port's own kv_norm -> projection of the
    joined input (zero-padded to a multiple of 8)."""
    c = n_pix + n_enc
    rng = np.random.default_rng(5)
    x_pix = rng.normal(size=(2, 50, n_pix)).astype(np.float32)
    enc = rng.normal(size=(50, n_enc)).astype(np.float32)
    jca = jmodules.CrossAttention(num_heads=1, num_q_input_channels=32, num_kv_input_channels=c,
                                  num_qk_channels=qk)
    xq = jnp.zeros((2, 4, 32), jnp.float32)
    jparams = jca.init(jax.random.PRNGKey(2), xq, x_kv=jnp.zeros((2, 50, c), jnp.float32))
    # non-trivial LayerNorm weights
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32) if "kv_norm" in str(path) else a,
        jparams)
    want = jca.apply(jparams, jnp.asarray(x_pix), jnp.asarray(enc), method="split_kv_projection")
    tca = CrossAttention(1, 32, c, num_qk_channels=qk)
    p = jax.tree.map(np.asarray, jparams["params"])
    from perceiver_io_tpu_torch.convert import _attention, _layernorm
    sd = {}
    _layernorm(p["q_norm"], "q_norm", sd)
    _layernorm(p["kv_norm"], "kv_norm", sd)
    _attention(p["attention"], "attention", sd)
    tca.load_state_dict(sd, strict=True)
    with torch.no_grad():
        k, v, k_pad, v_pad = tca.split_kv_projection(torch.from_numpy(x_pix), torch.from_numpy(enc))
        joined = tca.kv_norm(torch.cat([torch.from_numpy(x_pix), torch.from_numpy(enc)[None].expand(2, -1, -1)], -1))
        k_std, v_std = tca.attention.k_proj(joined), tca.attention.v_proj(joined)
    assert (k_pad, v_pad) == (int(want[2]), int(want[3])) == (split_padded(qk) - qk,) * 2
    np.testing.assert_allclose(k.numpy(), np.asarray(want[0]), atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(want[1]), atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(k[..., :qk].numpy(), k_std.numpy(), atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(v[..., :qk].numpy(), v_std.numpy(), atol=KV_ATOL, rtol=0)
    assert not k[..., qk:].any() and not v[..., qk:].any()


class _FlashRoutes:
    """Counts the port's flash entry points by name."""

    def __init__(self, monkeypatch):
        from perceiver_io_tpu_torch.core import attention as tattention

        self.calls = []
        for mod, name in ((tattention, "flash_attention"), (tattention, "flash_attention_packed"),
                          (tmodules, "flash_attention")):
            monkeypatch.setattr(mod, name, self._spy(f"{mod.__name__.split('.')[-1]}.{name}", getattr(mod, name)))

    def _spy(self, name, fn):
        def spy(*a, **kw):
            self.calls.append(name)
            return fn(*a, **kw)
        return spy


@pytest.mark.parametrize("case,want", [
    ("split", {"modules.flash_attention": 1, "attention.flash_attention_packed": 3}),
    ("pad_mask", {"attention.flash_attention": 1, "attention.flash_attention_packed": 3}),
    ("heads3", {"attention.flash_attention": 1, "attention.flash_attention_packed": 3}),
])
def test_routes(monkeypatch, case, want):
    """Per forward: the cross-attention on the split route (the fused layer
    calls the heads-major kernel itself) or through ``MultiHeadAttention``'s
    heads-major route; the packed kernel for the weight-shared block's two
    self-attention calls (head dim 16) and for the decoder's single query
    (one head of 32 channels; the flagship's 1024 take the dense path)."""
    _, tcfg = _configs(8, 3, 36) if case == "heads3" else _configs()
    tm = ImageClassifier(tcfg, device="cpu")
    routes = _FlashRoutes(monkeypatch)
    pad = torch.zeros(2, IMAGE[0] * IMAGE[1], dtype=torch.bool) if case == "pad_mask" else None
    with torch.no_grad():
        tm(torch.from_numpy(_images()), pad_mask=pad)
    counts = {name: routes.calls.count(name) for name in set(routes.calls)}
    assert counts == want


def test_weight_bridge_names_the_reference_checkpoint(models):
    """Every port parameter comes from the JAX tree, under the reference
    names ``hf/lightning_ckpt.py`` reads."""
    sd = image_classifier_state_dict_from_jax(models[1])
    assert {"0.latent_provider._query", "1.output_query_provider._query", "1.output_adapter.linear.weight",
            "0.cross_attn_1.0.module.kv_norm.weight", "0.self_attn_1.0.0.module.norm.weight",
            "1.cross_attn.0.module.attention.q_proj.weight"} <= set(sd)
    assert set(sd) == set(models[2].state_dict())


def test_decoder_without_attention_residual():
    """``cross_attention_residual=False``: the attention output replaces the
    output query before the MLP, and the reference holds the attention
    unwrapped (``1.cross_attn.0.q_norm``, not ``0.module``)."""
    _, tcfg = _configs()
    tcfg.decoder.cross_attention_residual = False
    tm = ImageClassifier(tcfg, device="cpu")
    assert "1.cross_attn.0.q_norm.weight" in tm.state_dict()
    layer = tm.decoder.cross_attn
    query = torch.randn(2, 1, 32)
    latents = torch.randn(2, 128, 32)
    with torch.no_grad():
        h = layer.cross_attn(query, latents).last_hidden_state
        torch.testing.assert_close(layer(query, latents).last_hidden_state, h + layer[1].module(h), atol=0,
                                   rtol=0)


def test_unported_training_options_raise():
    """The encoder's dropout is ported now: a training forward with it runs
    (parity with JAX is in ``tests/test_torch_perceiver_io_options.py``),
    and the deterministic forward is unaffected."""
    _, tcfg = _configs()
    tcfg.encoder.dropout = 0.1
    tm = ImageClassifier(tcfg, device="cpu")
    x = torch.from_numpy(_images())
    logits = tm(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (2, 4) and bool(torch.isfinite(logits).all())
    with torch.no_grad():  # the deterministic forward is unaffected
        assert torch.equal(tm(x), ImageClassifier(_configs()[1], device="cpu")(x))


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageClassifier(_configs()[1])
