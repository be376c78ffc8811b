"""The port's packed flash attention backward (the plain version K4a/K4b are
held against on the card, wired through the autograd Function) against the
JAX package's ``flash_attention_packed`` VJP, whose Pallas backward kernels
(``_dkv_packed_kernel``, ``_dq_packed_kernel``) run in interpret mode on the
CPU under ``default_flash(True)``: causal and not, ``Nq < Nkv`` right-aligned,
a pad mask, lengths that are no block multiple. Also against torch autograd
of the plain forward, including ``Nq > Nkv`` (rows that see no key).

Tolerance: atol 1e-5 on gradients of order 1 to 4, about five times the
largest measured difference (2.2e-6 against JAX, 1.2e-6 against autograd;
f32, dense vs blockwise summation order, and the backward's recomputed
``exp(s - lse)`` against the forward's normalized softmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from perceiver_io_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_bwd_reference,
    flash_attention_packed_reference,
)

B, H, DQK, DV = 2, 2, 16, 8
ATOL = 1e-5


def _data(nq, nkv, n_pad, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, nq, H * DQK)) * DQK**-0.5).astype(np.float32)
    k = rng.normal(size=(B, nkv, H * DQK)).astype(np.float32)
    v = rng.normal(size=(B, nkv, H * DV)).astype(np.float32)
    do = rng.normal(size=(B, nq, H * DV)).astype(np.float32)
    pad = None
    if n_pad:
        pad = np.zeros((B, nkv), bool)
        pad[1, :n_pad] = True
    return q, k, v, do, pad


def _port_grads(q, k, v, do, pad, causal, sm_scale=1.0):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tpad = None if pad is None else torch.from_numpy(pad)
    o = flash_attention_packed(*t, num_heads=H, pad_mask=tpad, causal=causal, sm_scale=sm_scale)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    return [x.grad.numpy() for x in t]


@pytest.mark.parametrize(
    "causal,nq,nkv,n_pad",
    [
        (False, 32, 32, 0),
        (True, 32, 32, 0),
        (True, 24, 72, 0),   # right-aligned: query i sees keys j <= i + 48
        (False, 24, 72, 5),  # pad mask
        (True, 37, 53, 3),   # no block multiple, causal + pad, every row sees a real key
    ],
)
def test_packed_grads_match_jax_vjp(causal, nq, nkv, n_pad):
    q, k, v, do, pad = _data(nq, nkv, n_pad)
    with default_flash(True):
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_packed(
                q_, k_, v_, num_heads=H, pad_mask=None if pad is None else jnp.asarray(pad), causal=causal,
            ),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        )
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do, pad, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize(
    "causal,nq,nkv,n_pad",
    [(True, 24, 72, 5), (False, 40, 40, 0), (True, 40, 29, 0)],  # the last: Nq > Nkv, 11 rows see nothing
)
def test_packed_grads_match_autograd_of_the_plain_forward(causal, nq, nkv, n_pad):
    q, k, v, do, pad = _data(nq, nkv, n_pad, seed=1)
    scale = 0.7
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tpad = None if pad is None else torch.from_numpy(pad)
    o, _ = flash_attention_packed_reference(*t, num_heads=H, pad_mask=tpad, causal=causal, sm_scale=scale)
    o.backward(torch.from_numpy(do))
    got = _port_grads(q, k, v, do, pad, causal, sm_scale=scale)
    for name, g, x in zip("qkv", got, t):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, x.grad.numpy(), atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_function_backward_is_the_plain_backward_on_the_cpu():
    """On CPU tensors the Function's backward is the plain backward that K4a
    and K4b are held against on the card, bit for bit."""
    q, k, v, do, pad = _data(21, 50, 4, seed=2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tpad = torch.from_numpy(pad)
    o, lse = flash_attention_packed_reference(*t, num_heads=H, pad_mask=tpad, causal=True)
    want = flash_attention_packed_bwd_reference(*t, o, lse, torch.from_numpy(do), H, tpad, causal=True)
    got = _port_grads(q, k, v, do, pad, causal=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


def test_bias_and_pad_mask_get_no_gradient_and_lse_none():
    q, k, v, do, pad = _data(8, 16, 2, seed=3)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = flash_attention_packed(*t, num_heads=H, pad_mask=torch.from_numpy(pad), causal=True, return_lse=True)
    assert not lse.requires_grad
    (o.sum() + lse.sum()).backward()
    assert all(x.grad is not None for x in t)
