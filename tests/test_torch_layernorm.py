"""The port's LayerNorm forward (the plain version K1 is held against on the
card, and the module around it) against the JAX package's ``layer_norm``:
its Pallas kernel in interpret mode (``fused_ln(True)``) and its fallback.

Tolerances: f32 atol 1e-5 (same formula, sums taken in another order); a
bf16 output within one bf16 step (rtol 2**-7), since an f32 difference in the
last place can round the cast either way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.layernorm import fused_ln
from perceiver_io_tpu.ops.layernorm import layer_norm as jax_layer_norm
from perceiver_io_tpu_torch.ops.layernorm import FusedLayerNorm, layer_norm, layer_norm_reference


def _data(rng, shape):
    c = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(c,)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    return x, w, b


def _jax(x, w, b, fused, dtype=None):
    with fused_ln(fused):
        y = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-5, dtype=dtype)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("fused", [True, False], ids=["pallas", "fallback"])
@pytest.mark.parametrize("shape", [(4, 32, 128), (96, 256)])
def test_layer_norm_matches_jax_f32(rng, fused, shape):
    x, w, b = _data(rng, shape)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), _jax(x, w, b, fused), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["pallas", "fallback"])
def test_layer_norm_matches_jax_bf16_input(rng, fused):
    x, w, b = _data(rng, (64, 128))
    # the same f32 values rounded to bf16 by both frameworks (round to nearest even)
    got = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    want = _jax(jnp.asarray(x).astype(jnp.bfloat16), w, b, fused)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-6)


def test_layer_norm_f32_input_bf16_output_keeps_f32_stats(rng):
    x, w, b = _data(rng, (32, 128))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax(x, w, b, False, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-6)


def test_fused_layer_norm_module(rng):
    """Reference parameter names (``weight``/``bias``), unit/zero init, and a
    CPU tensor takes the plain version."""
    x, w, b = _data(rng, (8, 128))
    mod = FusedLayerNorm(128)
    assert sorted(n for n, _ in mod.named_parameters()) == ["bias", "weight"]
    assert torch.equal(mod.weight, torch.ones(128)) and torch.equal(mod.bias, torch.zeros(128))
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x))
    want = layer_norm_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _jax(x, w, b, False), atol=1e-5, rtol=0)
