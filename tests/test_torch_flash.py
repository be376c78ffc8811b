"""The port's packed flash attention forward (the plain version K2 is held
against on the card) against the JAX package's ``flash_attention_packed``,
whose Pallas kernel runs in interpret mode on the CPU: causal and not,
``Nq < Nkv`` right-aligned, a pad mask, lengths that are no block multiple.
Tolerance: atol 2e-5 (f32, online vs dense softmax summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from perceiver_io_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    flash_attention_packed,
    flash_attention_packed_reference,
)

B, H, DQK, DV = 2, 2, 16, 8


def _data(nq, nkv, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, nq, H * DQK)) * DQK**-0.5).astype(np.float32)
    k = rng.normal(size=(B, nkv, H * DQK)).astype(np.float32)
    v = rng.normal(size=(B, nkv, H * DV)).astype(np.float32)
    return q, k, v


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
def test_packed_matches_jax(causal, nq, nkv, n_pad):
    q, k, v = _data(nq, nkv)
    pad = np.zeros((B, nkv), bool)
    pad[1, :n_pad] = True
    pad_arg = pad if n_pad else None
    want = np.asarray(jax_flash_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H,
        pad_mask=None if pad_arg is None else jnp.asarray(pad_arg), causal=causal,
    ))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tpad = None if pad_arg is None else torch.from_numpy(pad_arg)
    got, lse = flash_attention_packed(*t, num_heads=H, pad_mask=tpad, causal=causal, return_lse=True)
    assert got.shape == (B, nq, H * DV) and lse.shape == (B, nq, H)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the logsumexp against a direct f64 computation over the visible keys
    s = np.einsum("bihc,bjhc->bhij", q.reshape(B, nq, H, DQK).astype(np.float64),
                  k.reshape(B, nkv, H, DQK).astype(np.float64))
    s = s + np.where(pad, MASK_VALUE, 0.0)[:, None, None, :]
    if causal:
        i, j = np.arange(nq)[:, None], np.arange(nkv)[None, :]
        s = np.where(j > i + (nkv - nq), -np.inf, s)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0].transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=0)


def test_cpu_dispatch_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _data(16, 40, seed=1))
    pad = torch.zeros(B, 40, dtype=torch.bool)
    pad[0, :7] = True
    got = flash_attention_packed(q, k, v, H, pad_mask=pad, causal=True)
    want, _ = flash_attention_packed_reference(q, k, v, H, pad_mask=pad, causal=True)
    assert torch.equal(got, want)


def test_fully_masked_row_is_the_uniform_average():
    """A row whose visible keys are all padding averages those keys' values
    uniformly under the finite mask value (not 0, not NaN); K2 keeps the same
    rule. The JAX kernel's answer for such a row depends on its block size, so
    this pins the port's own contract."""
    nq = nkv = 8
    q, k, v = (torch.from_numpy(a) for a in _data(nq, nkv, seed=2))
    pad = torch.zeros(B, nkv, dtype=torch.bool)
    pad[:, :3] = True
    o, _ = flash_attention_packed_reference(q, k, v, H, pad_mask=pad, causal=True)
    v4 = v.reshape(B, nkv, H, DV)
    for i in range(3):  # rows 0..2 see only padded keys 0..i
        want = v4[:, : i + 1].mean(dim=1).reshape(B, H * DV)
        torch.testing.assert_close(o[:, i], want, atol=1e-6, rtol=0)
    assert torch.isfinite(o).all()
