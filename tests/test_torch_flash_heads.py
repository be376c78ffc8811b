"""The port's heads-major flash attention (``flash_attention``, the plain
version K8/K9a/K9b are held against on the card) against the JAX package's
``flash_attention``, whose Pallas kernels run in interpret mode on the CPU:
the forward, at head dims 12, 40, 133 (zero-padded to 16, 40, 136) and 264,
one and two heads, causal and not, with and without a pad mask, Nq/Nkv
130/300 (no block multiple). Plus the contracts that differ from JAX's (a
row whose visible keys are all padded, a row that sees no key), the
dispatch of ``MultiHeadAttention`` by head dims and the single-query dense
route of the classifier's decoder. The gradients are in
``tests/test_torch_flash_heads_bwd.py``.

Tolerance: atol 2e-5 on outputs of magnitude ~1 (f32; online vs dense
softmax summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core.attention import MultiHeadAttention as JaxMHA
from perceiver_io_tpu.ops.flash_attention import flash_attention as jax_flash
from perceiver_io_tpu_torch.core import attention as tattention
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.ops import flash_attention as tflash
from perceiver_io_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    flash_attention,
    flash_attention_reference,
    flash_supported,
)

NQ, NKV, N_PAD = 130, 300, 37
ATOL = 2e-5


def heads_data(b, h, nq, nkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, nq, d)) * d**-0.5).astype(np.float32)
    k = rng.normal(size=(b, h, nkv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nkv, d)).astype(np.float32)
    return q, k, v


def pad_mask(b, nkv, n_pad):
    pad = np.zeros((b, nkv), bool)
    pad[1, :n_pad] = True
    return pad


@pytest.mark.parametrize("masked", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("d", [12, 40, 133, 264])
def test_flash_attention_matches_jax(d, h, causal, masked):
    q, k, v = heads_data(2, h, NQ, NKV, d)
    pad = pad_mask(2, NKV, N_PAD) if masked else None
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                pad_mask=None if pad is None else jnp.asarray(pad), causal=causal))
    got, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               pad_mask=None if pad is None else torch.from_numpy(pad), causal=causal,
                               return_lse=True)
    assert got.shape == (2, h, NQ, d) and lse.shape == (2, h, NQ)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the logsumexp against a direct f64 computation over the visible keys
    s = np.einsum("bhic,bhjc->bhij", q.astype(np.float64), k.astype(np.float64))
    if pad is not None:
        s = s + np.where(pad, MASK_VALUE, 0.0)[:, None, None, :]
    if causal:
        i, j = np.arange(NQ)[:, None], np.arange(NKV)[None, :]
        s = np.where(j > i + (NKV - NQ), -np.inf, s)
    m = s.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(), (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0],
                               atol=ATOL, rtol=0)


def test_cpu_dispatch_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in heads_data(2, 3, 17, 40, 24, seed=1))
    pad = torch.zeros(2, 40, dtype=torch.bool)
    pad[0, :7] = True
    got = flash_attention(q, k, v, pad_mask=pad, causal=True, sm_scale=0.7)
    want, _ = flash_attention_reference(q, k, v, pad_mask=pad, causal=True, sm_scale=0.7)
    assert torch.equal(got, want)


def test_heads_beyond_512_are_refused():
    assert flash_supported(512, 512) and flash_supported(12, 264)
    assert not flash_supported(513, 8) and not flash_supported(8, 1024)
    q = torch.zeros(1, 1, 4, 520)
    with pytest.raises(ValueError, match="512"):
        flash_attention(q, q, q)


def test_all_padded_row_averages_its_visible_keys_unlike_jax():
    """Difference of contract: a row whose visible keys are all padded gets
    the uniform average of those keys' values in the port (K8 keeps the
    rule); JAX pads the kv axis to its block (here 300 -> 512 slots of zero
    values, all at MASK_VALUE) and averages over every slot, so its answer
    depends on its block size."""
    q, k, v = heads_data(2, 1, NQ, NKV, 16, seed=2)
    pad = np.zeros((2, NKV), bool)
    pad[1] = True
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), pad_mask=torch.from_numpy(pad))
    want_port = np.broadcast_to(v[1].mean(axis=1, keepdims=True), (1, NQ, 16))
    np.testing.assert_allclose(got[1].numpy(), want_port, atol=1e-6, rtol=0)
    jax_out = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad_mask=jnp.asarray(pad)))
    np.testing.assert_allclose(jax_out[1], np.broadcast_to(v[1].sum(axis=1, keepdims=True) / 512, (1, NQ, 16)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), jax_out[0], atol=ATOL, rtol=0)  # the unpadded row agrees


def test_row_that_sees_no_key_is_zero_with_lse_minus_inf():
    """Nq > Nkv, causal: the first Nq - Nkv rows see no key; the port gives
    them 0 and logsumexp -inf (K8 too), and a zero gradient."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in heads_data(1, 2, 50, 20, 8, seed=3))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o[:, :, :30], torch.zeros_like(o[:, :, :30]))
    assert bool(torch.isneginf(lse[:, :, :30]).all()) and bool(torch.isfinite(lse[:, :, 30:]).all())
    o.sum().backward()
    assert torch.equal(q.grad[:, :, :30], torch.zeros_like(q.grad[:, :, :30]))
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()


class _Routes:
    """Counts the calls of each attention route of ``MultiHeadAttention``."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("flash_attention", "flash_attention_packed"):
            fn = getattr(tattention, name)
            monkeypatch.setattr(tattention, name, self._spy(name, fn))
        dense = MultiHeadAttention._dense
        monkeypatch.setattr(MultiHeadAttention, "_dense",
                            lambda mha, *a, **kw: self.calls.append("dense") or dense(mha, *a, **kw))

    def _spy(self, name, fn):
        def spy(*a, **kw):
            self.calls.append(name)
            return fn(*a, **kw)
        return spy


@pytest.mark.parametrize("heads,channels,route", [
    (2, 24, "flash_attention"),          # head dim 12: heads-major
    (1, 264, "flash_attention"),         # one wide head
    (2, 128, "flash_attention_packed"),  # head dim 64: packed
    (1, 1024, "dense"),                  # over 512: JAX's dense route
])
def test_mha_routes_by_head_dims(monkeypatch, heads, channels, route):
    """Cache-free and prefill calls take the packed kernel, the heads-major
    kernel or the dense path by head dims alone, at any sequence length."""
    from perceiver_io_tpu_torch.core.cache import init_kv_cache

    routes = _Routes(monkeypatch)
    torch.manual_seed(4)
    mha = MultiHeadAttention(heads, channels, channels, causal_attention=True)
    x = torch.randn(2, 9, channels)
    with torch.no_grad():
        want = mha(x, x).last_hidden_state
        cache = init_kv_cache(2, 16, channels, channels, device="cpu")
        got = mha(x, x, kv_cache=cache).last_hidden_state  # the prefill route
    assert routes.calls == [route, route]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_project_and_merge_compose_to_the_heads_major_route():
    """``project_q``/``project_kv``, ``flash_attention`` and ``merge_output``
    give exactly the cache-free forward of a layer on the heads-major route
    (head dim 12, rotary queries and keys, a pad mask)."""
    from perceiver_io_tpu_torch.core.position import frequency_position_encoding, positions

    torch.manual_seed(7)
    mha = MultiHeadAttention(2, 24, 24, causal_attention=True)
    x = torch.randn(2, 9, 24)
    rope = frequency_position_encoding(positions(2, 9), 8)
    pad = torch.zeros(2, 9, dtype=torch.bool)
    pad[1, :2] = True
    with torch.no_grad():
        want = mha(x, x, pad_mask=pad, rope_q=rope, rope_k=rope).last_hidden_state
        o = flash_attention(mha.project_q(x, rope), *mha.project_kv(x, rope), pad_mask=pad, causal=True)
        got = mha.merge_output(o)
    assert torch.equal(got, want)


@pytest.mark.parametrize("heads,channels,causal", [(2, 24, True), (1, 264, False)])
def test_mha_heads_major_route_matches_jax(heads, channels, causal):
    """``MultiHeadAttention`` on the heads-major route against JAX's under
    ``default_flash(True)`` (its heads-major kernel in interpret mode), with
    a pad mask and a causal layer, from converted weights."""
    import jax

    from perceiver_io_tpu.ops.flash_attention import default_flash
    from perceiver_io_tpu_torch.convert import _attention

    rng = np.random.default_rng(5)
    xq = rng.normal(size=(2, 130, channels)).astype(np.float32)
    xkv = rng.normal(size=(2, 300, channels)).astype(np.float32)
    pad = pad_mask(2, 300, N_PAD)
    jm = JaxMHA(num_heads=heads, num_q_input_channels=channels, num_kv_input_channels=channels,
                causal_attention=causal)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xq), jnp.asarray(xkv))
    with default_flash(True):
        want = np.asarray(jm.apply(params, jnp.asarray(xq), jnp.asarray(xkv), pad_mask=jnp.asarray(pad))
                          .last_hidden_state)
    tm = MultiHeadAttention(heads, channels, channels, causal_attention=causal)
    sd = {}
    _attention(jax.tree.map(np.asarray, params["params"]), "", sd)
    tm.load_state_dict({k[1:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(xq), torch.from_numpy(xkv), pad_mask=torch.from_numpy(pad)).last_hidden_state
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_single_query_dense_route_matches_jax():
    """The classifier decoder's cross-attention: one query, one head of 1024
    channels (over 512: the dense path in both packages) over 512 latents.
    Tolerance 2e-5 (f32 sums over 1024 channels in another order)."""
    import jax

    from perceiver_io_tpu_torch.convert import _attention

    rng = np.random.default_rng(6)
    xq = rng.normal(size=(2, 1, 1024)).astype(np.float32)
    xkv = rng.normal(size=(2, 512, 1024)).astype(np.float32)
    jm = JaxMHA(num_heads=1, num_q_input_channels=1024, num_kv_input_channels=1024)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(xq), jnp.asarray(xkv))
    want = np.asarray(jm.apply(params, jnp.asarray(xq), jnp.asarray(xkv)).last_hidden_state)
    tm = MultiHeadAttention(1, 1024, 1024)
    sd = {}
    _attention(jax.tree.map(np.asarray, params["params"]), "", sd)
    tm.load_state_dict({k[1:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(xq), torch.from_numpy(xkv)).last_hidden_state
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_kv_splits_fill_whole_waves():
    """The kv walk is split across the SMs (132 on an H100 SXM) that one CTA
    per q block leaves idle, in one wave and no more: the image classifier's
    cross-attention (8 q blocks of 64 rows an image, 784 kv tiles of 64 for
    K8, 1568 of 32 for K9b) at batch 1, 2 and 16; 5 q blocks fill 26 splits
    of a wave, capped so that a split walks at least 8 tiles; a short kv walk
    is not split."""
    assert [tflash._kv_splits(b, 512, 64, 784, 132) for b in (1, 2, 16)] == [16, 8, 1]
    assert [tflash._kv_splits(b, 512, 64, 1568, 132) for b in (1, 2, 16)] == [16, 8, 1]
    assert tflash._kv_splits(5, 64, 64, 1568, 132) == 26
    assert tflash._kv_splits(5, 64, 64, 100, 132) == 12
    assert tflash._kv_splits(2, 130, 64, 5, 132) == 1


@pytest.mark.parametrize("bh,splits", [(16, 1), (2, 8)])
def test_k8_kv_split_at_the_main_path_shapes(bh, splits):
    """K8 at the image classifier's cross-attention (512 latents over 50176
    pixels, head dim 264; 64-row q blocks, 48-row kv tiles, one CTA an SM):
    16 x 8 q blocks at batch 16 fill 128 of 132 SMs unsplit; 2 x 8 at batch
    2 split the walk 8 ways, 128 CTAs in one wave."""
    assert tflash.heads_fwd_tiles(264) == (64, 48)
    n = tflash.heads_fwd_splits(bh, 512, 50176, 264, sms=132, slots=1)
    assert n == splits
    assert 0.9 * 132 < n * bh * 8 <= 132


@pytest.mark.parametrize("bh,nq,nkv,d,slots", [(16, 512, 50176, 264, 1), (2, 512, 50176, 264, 1), (1, 512, 50176, 264, 1),
                                               (4, 130, 300, 512, 1), (4, 100, 3000, 136, 1), (3, 200, 9000, 40, 2),
                                               (1, 64, 600, 64, 2), (64, 512, 4096, 128, 1)])
def test_k8_kv_split_never_adds_a_wave(bh, nq, nkv, d, slots):
    """A split fills the CTA slots one CTA per q block leaves idle, never
    needs a second wave, and keeps at least 8 kv tiles (48 rows up to head
    dim 288, 16 above) a split."""
    n = tflash.heads_fwd_splits(bh, nq, nkv, d, 132, slots)
    q_rows, kv_rows = tflash.heads_fwd_tiles(d)
    blocks = bh * -(-nq // q_rows)
    assert n >= 1 and (n == 1 or n * blocks <= slots * 132)
    assert n == 1 or -(-nkv // kv_rows) >= 8 * n
