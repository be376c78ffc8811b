"""The port's LayerNorm forward and backward (the plain versions K1 and K5
are held against on the card, the autograd Function and the module around
them) against the JAX package's ``layer_norm`` and its VJP: its Pallas
kernels in interpret mode (``fused_ln(True)``) and its fallback.

Tolerances: f32 atol 1e-5 (same formula, sums taken in another order); a
bf16 output within one bf16 step (rtol 2**-7), since an f32 difference in the
last place can round the cast either way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.layernorm import fused_ln
from perceiver_io_tpu.ops.layernorm import layer_norm as jax_layer_norm
from perceiver_io_tpu_torch.ops.layernorm import (
    FusedLayerNorm,
    layer_norm,
    layer_norm_bwd_partition,
    layer_norm_bwd_reference,
    layer_norm_reference,
)


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


def _port_grads(x, w, b, dy):
    t = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = layer_norm(*t)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    return [a.grad.numpy() for a in t]


# gradients, about four times the largest measured difference against JAX
# (f32, sums taken in another order): dx (values up to 2.7) within 2e-6,
# measured 4.8e-7; dgamma/dbeta (sums over up to 128 rows, values up to 37)
# within 4e-5, measured 9.5e-6
GRAD_ATOL = {"dx": 2e-6, "dw": 4e-5, "db": 4e-5}


@pytest.mark.parametrize("fused", [True, False], ids=["pallas", "fallback"])
@pytest.mark.parametrize("shape", [(4, 32, 128), (96, 256)])
def test_layer_norm_grads_match_jax_vjp(rng, fused, shape):
    """The port's autograd Function (its plain backward on the CPU, what K5
    is held against on the card) against JAX's VJP: the Pallas
    ``_bwd_kernel`` in interpret mode (``fused_ln(True)``) and the
    fallback's autodiff."""
    x, w, b = _data(rng, shape)
    dy = rng.normal(size=shape).astype(np.float32)
    with fused_ln(fused):
        _, vjp = jax.vjp(lambda x_, w_, b_: jax_layer_norm(x_, w_, b_, eps=1e-5),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    for name, g, wv in zip(("dx", "dw", "db"), _port_grads(x, w, b, dy), want):
        np.testing.assert_allclose(g, wv, atol=GRAD_ATOL[name], rtol=0, err_msg=name)


def test_layer_norm_grads_match_autograd_of_the_plain_forward(rng):
    x, w, b = _data(rng, (3, 40, 96))
    dy = rng.normal(size=x.shape).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    layer_norm_reference(*t).backward(torch.from_numpy(dy))
    for name, g, a in zip(("dx", "dw", "db"), _port_grads(x, w, b, dy), t):
        np.testing.assert_allclose(g, a.grad.numpy(), atol=GRAD_ATOL[name], rtol=0, err_msg=name)


def test_function_backward_is_the_plain_backward_on_the_cpu(rng):
    """On CPU tensors the Function saves the plain forward's statistics and
    its backward is :func:`layer_norm_bwd_reference`, bit for bit."""
    x, w, b = _data(rng, (50, 128))
    dy = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x)
    mean = xt.mean(dim=-1)
    rstd = torch.rsqrt(torch.clamp((xt * xt).mean(dim=-1) - mean * mean, min=0.0) + 1e-5)
    want = layer_norm_bwd_reference(xt, torch.from_numpy(w), mean, rstd, torch.from_numpy(dy))
    for g, wv in zip(_port_grads(x, w, b, dy), want):
        assert np.array_equal(g, wv.numpy())


def test_no_grad_forward_is_unchanged(rng):
    """Without grad the forward is the plain one (on the card: K1 without
    statistics, the serving launch)."""
    x, w, b = (torch.from_numpy(a).requires_grad_() for a in _data(rng, (16, 128)))
    with torch.no_grad():
        y = layer_norm(x, w, b)
    assert y.grad_fn is None and torch.equal(y, layer_norm_reference(x.detach(), w.detach(), b.detach()))


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


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_rows,n_cols", [(8192, 1024), (15360, 512), (37, 128), (1000, 261), (1, 512),
                                           (12345, 1024), (15361, 512)])
def test_k5_partition_covers_every_row_once_in_fixed_groups(n_rows, n_cols, sms):
    """K5's first pass (``layer_norm_bwd_partition``): program p walks rows
    [p * rows_per_prog, min(n_rows, (p + 1) * rows_per_prog)) in whole
    blocks of block_r rows (at most 4096 elements a block, as K1 holds), so
    the programs cover every row exactly once, each a contiguous run in row
    order, none empty, and no more programs than one an SM; at the main
    path's shapes (the image classifier's 8192 x 1024 latent rows, the CLM
    chunk's 15360 x 512 kv rows) and ragged row counts."""
    block_r, rows_per_prog, n_progs = layer_norm_bwd_partition(n_rows, n_cols, sms)
    block_c = 1 << (n_cols - 1).bit_length()
    assert block_r >= 1 and block_r * block_c <= 4096 and rows_per_prog % block_r == 0
    assert 1 <= n_progs <= sms
    runs = [range(p * rows_per_prog, min(n_rows, (p + 1) * rows_per_prog)) for p in range(n_progs)]
    assert all(len(r) > 0 for r in runs)
    assert [i for r in runs for i in r] == list(range(n_rows))
    if n_rows >= 64 * sms:  # the main path's shapes fill the card
        assert n_progs > 0.9 * sms
