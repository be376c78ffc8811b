"""The port's bf16 kernel paths on the CPU (the plain versions K2, K4a/K4b
and K3 are held against on the card) against the JAX package's Pallas kernels
in interpret mode on bf16 operands: the packed flash forward and its
gradients (``flash_attention_packed`` and its VJP under
``default_flash(True)``), and the paged decode over bf16 pools
(``paged_decode_attention``) with a shuffled page table, a length-0 slot and
a pad mask.

Tolerance rule, for each output: the port's bf16 result lies no further from
the f32 evaluation of the same (bf16-representable) inputs than 1.5 times
JAX's bf16 result does, plus 1e-3 times the size of the f32 output, all in
the L2 norm (the largest single difference of two bf16 evaluations is too
noisy a statistic: over a 64-element LayerNorm gradient it varied by 1.7x
between the two frameworks, their L2 distances by at most 1.31x). The two frameworks round at the same points but sum in other orders
(and the port's forward keeps ``p`` in f32 for ``P V``, where JAX rounds it),
so neither matches the other bit for bit; each is as far from f32 as bf16
makes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core import cache as jcache
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from perceiver_io_tpu.ops.paged_attention import paged_attention_reference as jax_paged_reference
from perceiver_io_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from perceiver_io_tpu_torch.core import cache as tcache
from perceiver_io_tpu_torch.ops.flash_attention import flash_attention_packed
from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

B, H, D = 2, 4, 16  # the micro CLM's heads: 64 channels in 4 heads


def bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even), as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_bf16_rule(port, jax_bf16, f32, what: str) -> None:
    """The port's bf16 output no further from the f32 evaluation than 1.5x
    JAX's bf16 output, plus 1e-3 of the f32 output's size (distances and
    size in the L2 norm)."""
    port, jax_bf16, f32 = (np.asarray(x, np.float64) for x in (port, jax_bf16, f32))
    assert port.shape == jax_bf16.shape == f32.shape, what
    d_port, d_jax = np.linalg.norm(port - f32), np.linalg.norm(jax_bf16 - f32)
    bound = 1.5 * d_jax + 1e-3 * np.linalg.norm(f32)
    assert np.isfinite(d_port) and d_port <= bound, f"{what}: port {d_port:.3e} > {bound:.3e} (JAX {d_jax:.3e})"


def _flash_data(nq, nkv, n_pad, seed):
    rng = np.random.default_rng(seed)
    q = bf16_values(rng.normal(size=(B, nq, H * D)) * D**-0.5)
    k, v = (bf16_values(rng.normal(size=(B, nkv, H * D))) for _ in range(2))
    do = bf16_values(rng.normal(size=(B, nq, H * D)))
    pad = None
    if n_pad:
        pad = np.zeros((B, nkv), bool)
        pad[1, :n_pad] = True
    return q, k, v, do, pad


def _jax_flash(q, k, v, do, pad, causal, dtype):
    with default_flash(True):
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_packed(q_, k_, v_, num_heads=H,
                                                pad_mask=None if pad is None else jnp.asarray(pad), causal=causal),
            *(jnp.asarray(a, dtype) for a in (q, k, v)),
        )
        grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (True, 128, 128, 0),   # a latent self-attention
    (True, 64, 192, 0),    # the cross-attention's right-aligned causal limit
    (False, 40, 72, 5),    # a pad mask, no block multiple
    (True, 37, 53, 3),     # causal + pad, every row sees a real key
])
def test_packed_flash_bf16_forward_and_gradients_match_jax(causal, nq, nkv, n_pad):
    q, k, v, do, pad = _flash_data(nq, nkv, n_pad, seed=nq + nkv)
    f32 = _jax_flash(q, k, v, do, pad, causal, jnp.float32)
    jbf = _jax_flash(q, k, v, do, pad, causal, jnp.bfloat16)
    t = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    o = flash_attention_packed(*t, num_heads=H, pad_mask=None if pad is None else torch.from_numpy(pad),
                               causal=causal)
    assert o.dtype == torch.bfloat16
    o.backward(torch.tensor(do).bfloat16())
    port = [o.detach().float().numpy()] + [x.grad.float().numpy() for x in t]
    assert all(x.grad.dtype == torch.bfloat16 for x in t)
    for name, p, j, f in zip(("out", "dq", "dk", "dv"), port, jbf, f32):
        assert_bf16_rule(p, j, f, name)


S, PAGE, PPS, PH, PD = 5, 8, 4, 4, 32  # H*D = 128 lanes, as the TPU kernel wants


def _paged_pools(seed):
    """A shuffled page table, slot 4 retired (length 0, its row at the
    scratch page), left pads in slots 1 and 3; bf16-representable values."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + S * PPS
    k, v = (bf16_values(rng.standard_normal((num_pages, PAGE, PH * PD))) for _ in range(2))
    table = (rng.permutation(num_pages - 1) + 1).astype(np.int32).reshape(S, PPS)
    table[4] = 0
    length = np.asarray([1, 9, 17, 32, 0], np.int32)
    cap = PPS * PAGE
    pads = np.zeros((S, cap), bool)
    pads[1, :3] = True
    pads[3, :5] = True
    q = bf16_values(rng.standard_normal((S, PH, PD)) * PD**-0.5)
    return q, k, v, table, length, pads


def _jax_cache(k, v, table, length, dtype):
    return jcache.PagedKVCache(k=jnp.asarray(k, dtype), v=jnp.asarray(v, dtype), page_table=jnp.asarray(table),
                               length=jnp.asarray(length))


def _torch_cache(k, v, table, length):
    return tcache.PagedKVCache(k=torch.from_numpy(k).bfloat16(), v=torch.from_numpy(v).bfloat16(),
                               page_table=torch.from_numpy(table), length=torch.from_numpy(length))


@pytest.mark.parametrize("masked", [False, True], ids=["validity_only", "pad_mask"])
def test_paged_decode_bf16_matches_jax(masked):
    q, k, v, table, length, pads = _paged_pools(seed=3)
    cap = PPS * PAGE
    full = (np.arange(cap)[None, :] >= length[:, None]) | (pads if masked else False)
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jc = _jax_cache(k, v, table, length, dtype)
        out[name] = np.asarray(jax_paged_decode(jnp.asarray(q, dtype), jc, jnp.asarray(full)).astype(jnp.float32))
    got = paged_decode_attention(torch.from_numpy(q).bfloat16(), _torch_cache(k, v, table, length),
                                 torch.from_numpy(pads) if masked else None)
    assert got.dtype == torch.bfloat16 and got.shape == (S, PH, PD)
    assert_bf16_rule(got.float().numpy(), out["bf16"], out["f32"], "paged decode")
    # the retired slot: the average of its capacity, the scratch page throughout
    np.testing.assert_allclose(got[4].float().numpy(), v[0].reshape(PAGE, PH, PD).mean(axis=0), atol=2e-2, rtol=0)


def test_paged_plain_version_rounds_the_weights_to_the_pools_dtype_as_jax():
    """The plain version rounds the softmax weights to bf16 before the value
    product, as JAX's plain version does: the two agree to the bf16 rounding
    of the output."""
    q, k, v, table, length, pads = _paged_pools(seed=4)
    tc = _torch_cache(k, v, table, length)
    got = paged_attention_reference(torch.from_numpy(q).bfloat16(), tc, torch.from_numpy(pads))
    assert got.dtype == torch.bfloat16
    full = (np.arange(PPS * PAGE)[None, :] >= length[:, None]) | pads
    want = jax_paged_reference(jnp.asarray(q, jnp.bfloat16), _jax_cache(k, v, table, length, jnp.bfloat16),
                               jnp.asarray(full))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=1e-3, rtol=2**-7)
