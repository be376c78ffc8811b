"""The gradients of the port's heads-major ``flash_attention`` (its autograd
Function, whose CPU backward is the plain version K9a/K9b are held against
on the card) against the VJP of the JAX package's ``flash_attention``
(Pallas ``_dkv_kernel``/``_dq_kernel`` in interpret mode): the cases of
``tests/test_torch_flash_heads.py``, head dims 12, 40, 133 and 264 (the
wrapper's zero padding included), one and two heads, causal and not, with
and without a pad mask, Nq/Nkv 130/300, one output cotangent from numpy
(std 0.25: sums over 130 queries or 300 keys of 133-wide rows would
otherwise reach gradients of ~14, where f32 rounding alone is 1e-6).

Tolerance: atol 1e-5 on gradients of magnitude up to ~4 (f32; the port sums
dense products, JAX blockwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.flash_attention import flash_attention as jax_flash
from perceiver_io_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

NQ, NKV, N_PAD = 130, 300, 37
ATOL = 1e-5


def _data(b, h, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, NQ, d)) * d**-0.5).astype(np.float32)
    k = rng.normal(size=(b, h, NKV, d)).astype(np.float32)
    v = rng.normal(size=(b, h, NKV, d)).astype(np.float32)
    do = (0.25 * rng.normal(size=(b, h, NQ, d))).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("masked", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("d", [12, 40, 133, 264])
def test_flash_attention_grads_match_jax_vjp(d, h, causal, masked):
    q, k, v, do = _data(2, h, d, seed=d + h)
    pad = None
    if masked:
        pad = np.zeros((2, NKV), bool)
        pad[1, :N_PAD] = True
    jpad = None if pad is None else jnp.asarray(pad)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, pad_mask=jpad, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*t, pad_mask=None if pad is None else torch.from_numpy(pad), causal=causal)
    o.backward(torch.from_numpy(do))
    for name, got, w in zip("qkv", t, want):
        np.testing.assert_allclose(got.grad.numpy(), w, atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_bwd_reference_is_what_the_function_computes():
    """The plain backward (what K9a/K9b are held against on the card) equals
    the autograd Function's CPU backward from the same saved output and
    logsumexp, on a padded, causal, odd-width case."""
    q, k, v, do = (torch.from_numpy(a) for a in _data(2, 2, 24, seed=7))
    pad = torch.zeros(2, NKV, dtype=torch.bool)
    pad[0, :11] = True
    kw = dict(pad_mask=pad, causal=True, sm_scale=0.5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, **kw).backward(do)
    o, lse = flash_attention_reference(q, k, v, **kw)
    for got, want in zip(leaves, flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)):
        torch.testing.assert_close(got.grad, want, atol=1e-6, rtol=0)
