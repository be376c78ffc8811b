"""The port's Perceiver IO image classifier in bf16 compute
(``ImageClassifier(config, dtype=torch.bfloat16)``, f32 parameters) against
the JAX package's ``ImageClassifier(config, dtype=jnp.bfloat16)`` at the
size of ``tests/test_torch_image.py`` (16x16x3 images, 8 Fourier bands: 37
input channels, padded to 40 on the split route; 128 latents x 32 channels,
2 self-attention heads, one layer per block, 2 weight-shared blocks, 4
classes), from the same parameters (``image_classifier_state_dict_from_jax``):
the split-kv K/V projection, the logits on the split route and on the
pad-mask route, the loss and the gradients of one train step; and the
heads-major flash attention in bf16 (the port's plain versions, which the
CPU runs in place of K8, K9a and K9b) against JAX's heads-major kernel at a
head dim of 40, no multiple of 16. JAX runs under ``default_flash(True)``:
its encoder takes the fused split-kv route and its Pallas kernels run in
interpret mode.

Tolerance rule, for each output (``tests/test_torch_bf16_clm.py``'s): the
port's bf16 result lies no further from the f32 evaluation of the same
weights (the JAX package in f32) than 1.5 times JAX's bf16 result does, plus
1e-3 times the size of the f32 output, all in the L2 norm. The key
projections' bias gradients, 0 in exact arithmetic (softmax shift
invariance), are held absolutely instead (``ZERO_GRAD_ATOL``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core import modules as jmodules
from perceiver_io_tpu.core.config import ClassificationDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifier as JaxImageClassifier
from perceiver_io_tpu.models.vision.image_classifier import ImageClassifierConfig as JaxImageClassifierConfig
from perceiver_io_tpu.models.vision.image_classifier import ImageEncoderConfig as JaxImageEncoderConfig
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from perceiver_io_tpu.training import classification_loss_fn as jax_classification_loss_fn
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import _attention, _layernorm, image_classifier_state_dict_from_jax
from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.core.modules import CrossAttention
from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig
from perceiver_io_tpu_torch.ops.flash_attention import flash_attention
from perceiver_io_tpu_torch.training.losses import _cross_entropy

IMAGE = (16, 16, 3)
PIXELS = IMAGE[0] * IMAGE[1]
# the key-projection bias gradients (0 in exact arithmetic) on both sides,
# relative to the largest gradient of the tree
ZERO_GRAD_ATOL = 1e-3


def assert_bf16_rule(port, jax_bf16, f32, what: str) -> None:
    """The port's bf16 output no further from the f32 evaluation than 1.5x
    JAX's bf16 output, plus 1e-3 of the f32 output's size (distances and
    size in the L2 norm)."""
    port, jax_bf16, f32 = (np.asarray(x, np.float64) for x in (port, jax_bf16, f32))
    assert port.shape == jax_bf16.shape == f32.shape, what
    d_port, d_jax = np.linalg.norm(port - f32), np.linalg.norm(jax_bf16 - f32)
    bound = 1.5 * d_jax + 1e-3 * np.linalg.norm(f32)
    assert np.isfinite(d_port) and d_port <= bound, f"{what}: port {d_port:.3e} > {bound:.3e} (JAX {d_jax:.3e})"


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs():
    enc = dict(image_shape=IMAGE, num_frequency_bands=8, num_cross_attention_heads=1, num_self_attention_heads=2,
               num_self_attention_layers_per_block=1, num_self_attention_blocks=2)
    dec = dict(num_classes=4, num_output_query_channels=32, num_cross_attention_heads=1)
    top = dict(num_latents=128, num_latent_channels=32)
    return (JaxImageClassifierConfig(encoder=JaxImageEncoderConfig(**enc), decoder=JaxDecoderConfig(**dec), **top),
            ImageClassifierConfig(encoder=ImageEncoderConfig(**enc), decoder=ClassificationDecoderConfig(**dec),
                                  **top))


def _images(b=2, seed=0):
    return np.random.default_rng(seed).normal(size=(b,) + IMAGE).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """JAX's f32 and bf16 classifiers on one parameter tree, the port's bf16
    classifier on the same parameters."""
    jcfg, tcfg = _configs()
    jf, jb = JaxImageClassifier(jcfg), JaxImageClassifier(jcfg, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0), jnp.asarray(_images())))
    tm = ImageClassifier(tcfg, dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    return jf, jb, params, tm


def test_bf16_classifier_loads_the_bridge_and_keeps_f32_parameters(models):
    """The weight bridge gives f32 tensors for every parameter of the bf16
    classifier (the same names as the f32 one's), and the loaded parameters
    stay f32 and equal to JAX's."""
    _, _, params, tm = models
    sd = image_classifier_state_dict_from_jax(params)
    assert set(sd) == set(tm.state_dict()) == set(ImageClassifier(_configs()[1], device="cpu").state_dict())
    assert tm.dtype == torch.bfloat16
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name
        assert torch.equal(p.detach(), sd[name]), name


@pytest.mark.parametrize("n_pix,n_enc,qk", [(3, 34, 37), (3, 130, 133)])
def test_split_kv_projection_bf16_matches_jax(n_pix, n_enc, qk):
    """K/V of the fused route in bf16 (f32 row statistics; the products and
    the rest in bf16) against JAX's bf16 ``split_kv_projection``, both held
    to JAX's f32 one; the padded channels exactly 0."""
    c = n_pix + n_enc
    rng = np.random.default_rng(5)
    x_pix = rng.normal(size=(2, 50, n_pix)).astype(np.float32)
    enc = rng.normal(size=(50, n_enc)).astype(np.float32)
    kw = dict(num_heads=1, num_q_input_channels=32, num_kv_input_channels=c, num_qk_channels=qk)
    jparams = jax.jit(lambda key: jmodules.CrossAttention(**kw).init(key, jnp.zeros((2, 4, 32)),
                                                                     x_kv=jnp.zeros((2, 50, c))))(
        jax.random.PRNGKey(2))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32) if "kv_norm" in str(path) else a,
        jparams)
    want = {name: jax.jit(lambda p, a, b, dt=dt: jmodules.CrossAttention(**kw, dtype=dt).apply(
                p, a, b, method="split_kv_projection"))(jparams, jnp.asarray(x_pix), jnp.asarray(enc))
            for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    tca = CrossAttention(1, 32, c, num_qk_channels=qk, dtype=torch.bfloat16)
    p = jax.tree.map(np.asarray, jparams["params"])
    sd = {}
    _layernorm(p["q_norm"], "q_norm", sd)
    _layernorm(p["kv_norm"], "kv_norm", sd)
    _attention(p["attention"], "attention", sd)
    tca.load_state_dict(sd, strict=True)
    with torch.no_grad():
        k, v, k_pad, v_pad = tca.split_kv_projection(torch.from_numpy(x_pix), torch.from_numpy(enc))
    assert k.dtype == v.dtype == torch.bfloat16 and (k_pad, v_pad) == (int(want["bf16"][2]), int(want["bf16"][3]))
    for i, name in ((0, "k"), (1, "v")):
        assert_bf16_rule((k, v)[i].float().numpy(), _f32(want["bf16"][i]), _f32(want["f32"][i]), name)
    assert not k[..., qk:].any() and not v[..., qk:].any()


def _jax_logits(models, x, pad):
    jf, jb, params, _ = models
    jpad = None if pad is None else jnp.asarray(pad)
    with default_flash(True):
        return {name: _f32(jax.jit(m.apply)(params, jnp.asarray(x), pad_mask=jpad))
                for name, m in (("f32", jf), ("bf16", jb))}


@pytest.mark.parametrize("route", ["split", "pad_mask"])
def test_logits_bf16_match_jax(models, route):
    """The logits on the fused split-kv route (no pad mask) and on the
    standard route (a pad mask: the joined input, kv_norm and the
    heads-major attention with a bias row)."""
    tm = models[3]
    x = _images(8, seed=1)  # 32 logits: the L2 distances of 8 varied by 2x from seed to seed
    pad = None
    if route == "pad_mask":
        pad = np.zeros((8, PIXELS), bool)
        pad[1::2, :40] = True
    want = _jax_logits(models, x, pad)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pad_mask=None if pad is None else torch.from_numpy(pad))
    assert got.dtype == torch.bfloat16 and got.shape == (8, 4)
    assert_bf16_rule(got.float().numpy(), want["bf16"], want["f32"], f"logits ({route})")


def test_dense_route_bf16_matches_jax():
    """The dense attention route in bf16, which carries the flagship
    decoder's one query head of 1024 channels (over the heads-major
    kernels' 512): one head of 520 qk/v channels from one output query over
    latents, scores and softmax in f32, the softmax cast to bf16 before
    ``attn @ v``, as JAX's einsum route."""
    from perceiver_io_tpu.core.attention import MultiHeadAttention as JaxMHA
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention

    rng = np.random.default_rng(9)
    xq, xkv = (_f32(jnp.asarray(rng.normal(size=s), jnp.bfloat16)) for s in ((2, 1, 64), (2, 40, 64)))
    kw = dict(num_heads=1, num_q_input_channels=64, num_kv_input_channels=64, num_qk_channels=520,
              num_v_channels=520)
    params = jax.jit(JaxMHA(**kw).init)(jax.random.PRNGKey(3), jnp.asarray(xq), jnp.asarray(xkv))
    want = {name: _f32(jax.jit(JaxMHA(**kw, dtype=dt).apply)(params, jnp.asarray(xq, dt),
                                                              jnp.asarray(xkv, dt)).last_hidden_state)
            for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    layer = MultiHeadAttention(1, 64, 64, num_qk_channels=520, num_v_channels=520, dtype=torch.bfloat16)
    p = params["params"]
    with torch.no_grad():
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            getattr(layer, proj).weight.copy_(torch.from_numpy(np.asarray(p[proj]["kernel"]).T.copy()))
            getattr(layer, proj).bias.copy_(torch.from_numpy(np.asarray(p[proj]["bias"]).copy()))
        got = layer(torch.from_numpy(xq).bfloat16(), torch.from_numpy(xkv).bfloat16()).last_hidden_state
    assert got.dtype == torch.bfloat16
    assert_bf16_rule(got.float().numpy(), want["bf16"], want["f32"], "dense route output")


@pytest.fixture(scope="module")
def step_grads(models):
    """One train step's loss and gradient tree (``classification_loss_fn``)
    in JAX f32, JAX bf16 and the port's bf16, on the split route."""
    jf, jb, params, tm = models
    rng = np.random.default_rng(3)
    batch = {"image": _images(seed=3), "label": rng.integers(0, 4, size=2)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    with default_flash(True):
        for name, m in (("f32", jf), ("bf16", jb)):
            (loss, _), grads = jax.jit(jax.value_and_grad(jax_classification_loss_fn(m.apply), has_aux=True))(
                params, jbatch, jax.random.PRNGKey(0))
            out[name] = (float(loss), image_classifier_state_dict_from_jax(jax.tree.map(np.asarray, grads)))
    tm.zero_grad()
    loss, _ = tt.classification_loss_fn()(tm, batch)
    loss.backward()
    out["port"] = (float(loss.detach()), {n: p.grad.detach().clone() for n, p in tm.named_parameters()})
    tm.zero_grad()
    return out


def test_loss_bf16_matches_jax(step_grads):
    assert_bf16_rule([step_grads["port"][0]], [step_grads["bf16"][0]], [step_grads["f32"][0]], "loss")


def test_gradients_bf16_match_jax(step_grads):
    """Every parameter's gradient under the rule (the key-projection biases
    absolutely), and the gradients f32, as the parameters are."""
    want32, want16, got = step_grads["f32"][1], step_grads["bf16"][1], step_grads["port"][1]
    assert sorted(got) == sorted(want32)
    scale = max(float(g.abs().max()) for g in want32.values())
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        if name.endswith("attention.k_proj.bias"):
            assert float(g.abs().max()) <= ZERO_GRAD_ATOL * scale, name
            assert float(want16[name].abs().max()) <= ZERO_GRAD_ATOL * scale, name
            continue
        assert_bf16_rule(g.numpy(), want16[name].numpy(), want32[name].numpy(), f"gradient {name}")


def test_bf16_train_step_keeps_f32_moments(models):
    """One AdamW step (clip 1.0, the JAX benchmark's optimizer) of the bf16
    classifier: f32 moments and parameters, a finite loss, every parameter
    updated from the f32 gradients."""
    _, _, params, _ = models
    tm = ImageClassifier(_configs()[1], dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(image_classifier_state_dict_from_jax(params), strict=True)
    state = tt.TrainState.create(tm, tt.make_optimizer(1e-3, gradient_clip=1.0))
    step = tt.make_train_step(tt.classification_loss_fn(), sentinel=True)
    rng = np.random.default_rng(4)
    state, metrics = step(state, {"image": _images(seed=4), "label": rng.integers(0, 4, size=2)})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["sentinel_skipped"]) == 0.0
    moments = [t for t in state.optimizer.state_tensors() if t.is_floating_point() and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    init = image_classifier_state_dict_from_jax(params)
    moved = [n for n, p in tm.named_parameters() if not torch.equal(p.detach(), init[n])]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert len(moved) >= len(init) - 2  # the two key-bias gradients are ~0


def test_loss_casts_bf16_logits_to_f32():
    """``_cross_entropy`` takes the log-softmax of the logits cast to f32
    (JAX's ``logits.astype(jnp.float32)``): bf16 logits give the f32 loss of
    their f32 values exactly."""
    logits = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    labels = torch.tensor([0, 3, 6, -100, 2])
    loss, n = _cross_entropy(logits, labels)
    want, _ = _cross_entropy(logits.float(), labels)
    assert loss.dtype == torch.float32 and int(n) == 4
    assert torch.equal(loss, want)


@pytest.mark.parametrize("causal,pad", [(False, False), (False, True), (True, True)],
                         ids=["full", "pad", "causal_pad"])
def test_heads_major_bf16_matches_the_jax_kernel(causal, pad):
    """The heads-major attention in bf16 at head dim 40 (no multiple of 16):
    the port's plain versions (``p`` rounded to bf16 before ``P V``, ``p``
    and ``dS`` before the gradient products) against JAX's Pallas kernel on
    the same bf16 inputs, the output and the three gradients, each held to
    JAX's f32 evaluation."""
    b, h, nq, nkv, d = 2, 2, 40, 72, 40
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, h, nq, d)) * d**-0.5
    k, v, do = rng.normal(size=(b, h, nkv, d)), rng.normal(size=(b, h, nkv, d)), rng.normal(size=(b, h, nq, d))
    q, k, v, do = (_f32(jnp.asarray(t, jnp.bfloat16)) for t in (q, k, v, do))
    mask = None
    if pad:
        mask = np.zeros((b, nkv), bool)
        mask[1, :9] = True
    want = {}
    with default_flash(True):
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            jm = None if mask is None else jnp.asarray(mask)
            def run(a, b_, c, g):
                o, vjp = jax.vjp(lambda x, y, z: jax_flash_attention(x, y, z, pad_mask=jm, causal=causal), a, b_, c)
                return (o, *vjp(g))

            want[name] = jax.jit(run)(*(jnp.asarray(t, dt) for t in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(t).bfloat16().requires_grad_() for t in (q, k, v))
    o = flash_attention(tq, tk, tv, pad_mask=None if mask is None else torch.from_numpy(mask), causal=causal)
    o.backward(torch.from_numpy(do).bfloat16())
    assert o.dtype == tq.grad.dtype == tk.grad.dtype == tv.grad.dtype == torch.bfloat16
    for i, (name, got) in enumerate((("o", o), ("dq", tq.grad), ("dk", tk.grad), ("dv", tv.grad))):
        assert_bf16_rule(got.detach().float().numpy(), _f32(want["bf16"][i]), _f32(want["f32"][i]), name)
