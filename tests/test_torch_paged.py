"""The port's paged decode attention (the plain version K3 is held against on
the card) against the JAX package's ``paged_decode_attention`` (its Pallas
page-walk kernel in interpret mode), and the port's paged-cache operations
and page allocator against ``core/cache.py`` and ``serving/pages.py``,
exactly. Attention tolerance: atol 2e-5 (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core import cache as jcache
from perceiver_io_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from perceiver_io_tpu.serving.pages import PageAllocator as JaxPageAllocator
from perceiver_io_tpu_torch.core import cache as tcache
from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention
from perceiver_io_tpu_torch.serving.pages import PageAllocator

S, PAGE, PPS, H, D = 5, 8, 4, 4, 32  # H*D = 128 lanes, as the TPU kernel wants


def _pools(rng, num_pages, c):
    return [rng.standard_normal((num_pages, PAGE, c)).astype(np.float32) for _ in range(2)]


def _caches(k, v, table, length):
    jc = jcache.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), page_table=jnp.asarray(table),
                             length=jnp.asarray(length))
    tc = tcache.PagedKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                             page_table=torch.from_numpy(table), length=torch.from_numpy(length))
    return jc, tc


def test_paged_decode_matches_jax_ragged_permuted():
    """Ragged lengths including a one-token slot, pages handed out in a
    permuted order. Slot 4 is retired (length 0, its row at the scratch
    page): every token of its capacity scores MASK_VALUE, so it gets the
    uniform average of the scratch page's values, in JAX, the plain version
    and K3 alike."""
    rng = np.random.default_rng(0)
    num_pages = 1 + S * PPS
    k, v = _pools(rng, num_pages, H * D)
    table = (rng.permutation(num_pages - 1) + 1).astype(np.int32).reshape(S, PPS)
    table[4] = 0  # a retired slot points at scratch
    length = np.asarray([1, 9, 17, 32, 0], np.int32)
    jc, tc = _caches(k, v, table, length)
    q = (rng.standard_normal((S, H, D)) * D**-0.5).astype(np.float32)
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jc))
    got = paged_decode_attention(torch.from_numpy(q), tc)
    assert got.shape == (S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[4], v[0].reshape(PAGE, H, D).mean(axis=0), atol=2e-5, rtol=0)


def test_all_masked_slot_matches_jax():
    """A slot whose every valid token the caller masks: with the finite
    MASK_VALUE its scores are all equal, and the port, like JAX, averages the
    slot's whole capacity (tokens past the length take MASK_VALUE too)."""
    rng = np.random.default_rng(5)
    num_pages = 1 + S * PPS
    k, v = _pools(rng, num_pages, H * D)
    table = np.arange(1, num_pages, dtype=np.int32).reshape(S, PPS)
    length = np.asarray([10, 12, 20, 31, 32], np.int32)
    jc, tc = _caches(k, v, table, length)
    cap = PPS * PAGE
    pads = np.zeros((S, cap), bool)
    pads[0, :10] = True  # every valid token of slot 0
    pads[4, :] = True  # slot 4 is full: its capacity is its valid tokens
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    got = paged_decode_attention(torch.from_numpy(q), tc, torch.from_numpy(pads)).numpy()
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jc,
                                       jnp.asarray(pads | (np.arange(cap)[None, :] >= length[:, None]))))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    rows = table[0].repeat(PAGE) * PAGE + np.tile(np.arange(PAGE), PPS)
    np.testing.assert_allclose(got[0], v.reshape(-1, H, D)[rows].mean(axis=0), atol=2e-5, rtol=0)


@pytest.mark.parametrize("mask_has_validity", [True, False])
def test_paged_decode_with_pad_mask_matches_jax(mask_has_validity):
    """A caller mask of left pads / expired window slots. The JAX function's
    mask replaces the slot validity, so it gets validity OR pads; the port's
    adds to the validity, so pads alone (what ``MultiHeadAttention`` passes)
    and validity OR pads give the same result."""
    rng = np.random.default_rng(1)
    num_pages = 1 + S * PPS
    k, v = _pools(rng, num_pages, H * D)
    table = np.arange(1, num_pages, dtype=np.int32).reshape(S, PPS)
    length = np.asarray([3, 12, 20, 31, 32], np.int32)
    jc, tc = _caches(k, v, table, length)
    cap = PPS * PAGE
    pads = np.zeros((S, cap), bool)
    pads[:, :2] = True  # two left pads per slot; every slot keeps a real key
    full = pads | (np.arange(cap)[None, :] >= length[:, None])
    mask = torch.from_numpy(full if mask_has_validity else pads)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jc, jnp.asarray(full)))
    got = paged_decode_attention(torch.from_numpy(q), tc, mask)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert torch.equal(got, paged_attention_reference(torch.from_numpy(q), tc, mask))


@pytest.mark.parametrize("which", ["query", "pool"])
def test_paged_decode_refuses_inputs_that_require_grad(which):
    """The paged decode has no gradient (nor has the JAX kernel a VJP): under
    grad mode an input that requires grad raises instead of returning an
    output cut off from the graph; without grad the call goes through."""
    rng = np.random.default_rng(4)
    k, v = _pools(rng, 1 + S * PPS, H * D)
    table = np.arange(1, 1 + S * PPS, dtype=np.int32).reshape(S, PPS)
    _, tc = _caches(k, v, table, np.full((S,), 5, np.int32))
    q = torch.from_numpy(rng.standard_normal((S, H, D)).astype(np.float32))
    if which == "query":
        q.requires_grad_()
    else:
        tc.k.requires_grad_()
    with pytest.raises(RuntimeError, match="has no gradient"):
        paged_decode_attention(q, tc)
    with torch.no_grad():
        assert torch.equal(paged_decode_attention(q, tc), paged_attention_reference(q, tc))


def test_paged_append_commit_release_match_jax_exactly():
    rng = np.random.default_rng(2)
    c, slots, pps, page = 16, 3, 3, 4
    jp = jcache.init_paged_kv_cache(slots, 1 + slots * pps, page, pps, c, c)
    tp = tcache.init_paged_kv_cache(slots, 1 + slots * pps, page, pps, c, c, device="cpu")
    # commit a 7-token prefill (capacity 9: slack past the tokens) into slot 1
    rows_k, rows_v = (rng.standard_normal((1, 7, c)).astype(np.float32) for _ in range(2))
    jpre = jcache.init_kv_cache(1, 9, c, c).append(jnp.asarray(rows_k), jnp.asarray(rows_v))
    tpre = tcache.init_kv_cache(1, 9, c, c, device="cpu")
    tpre = tpre.append(torch.from_numpy(rows_k), torch.from_numpy(rows_v))
    pages = np.asarray([5, 2], np.int32)
    jp = jcache.commit_prefill(jp, 1, jnp.asarray(pages), jpre, jpre.length)
    tp = tcache.commit_prefill(tp, 1, torch.from_numpy(pages), tpre, tpre.length)
    # one-token appends into every slot (slots 0 and 2 write into scratch)
    for _ in range(3):
        k, v = (rng.standard_normal((slots, 1, c)).astype(np.float32) for _ in range(2))
        jp = jp.append(jnp.asarray(k), jnp.asarray(v))
        tp = tp.append(torch.from_numpy(k), torch.from_numpy(v))
    jp = jcache.release_slot(jp, 1)
    tp = tcache.release_slot(tp, 1)
    for name in ("k", "v", "page_table", "length"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    jk, jv, _, _ = jp.gather_view()
    tk, tv, tks, tvs = tp.gather_view()
    assert tks is None and tvs is None and not tp.quantized
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_append_rejects_multi_token():
    tp = tcache.init_paged_kv_cache(1, 3, 4, 2, 8, 8, device="cpu")
    with pytest.raises(ValueError, match="one token per slot"):
        tp.append(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8))


def _bf16_bits(x) -> np.ndarray:
    """A bf16 array's bits, from either package (numpy has no bf16)."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_int8_paged_append_commit_release_match_jax_exactly():
    """The int8 counterpart of the float test above: int8 pools and an int8
    prefill cache, the rows quantized by ``quantize_kv`` at every write
    (commit, one-token appends, a span append), and the scale planes moved
    beside the rows: the pools, the scale planes (bf16 bits), the table, the
    lengths and the 4-tuple gather view all equal JAX's exactly. A quantized
    cache committed into a float pool (and the reverse) raises, as in JAX."""
    rng = np.random.default_rng(2)
    c, slots, pps, page = 16, 3, 3, 4
    jp = jcache.init_paged_kv_cache(slots, 1 + slots * pps, page, pps, c, c, dtype=jnp.int8)
    tp = tcache.init_paged_kv_cache(slots, 1 + slots * pps, page, pps, c, c, dtype=torch.int8, device="cpu")
    assert tp.quantized and tp.k_scale.shape == (1 + slots * pps, page) and tp.k_scale.dtype == torch.bfloat16
    rows_k, rows_v = (rng.standard_normal((1, 7, c)).astype(np.float32) * 3 for _ in range(2))
    jpre = jcache.init_kv_cache(1, 9, c, c, dtype=jnp.int8).append(jnp.asarray(rows_k), jnp.asarray(rows_v))
    tpre = tcache.init_kv_cache(1, 9, c, c, dtype=torch.int8, device="cpu")
    tpre = tpre.append(torch.from_numpy(rows_k), torch.from_numpy(rows_v))
    pages = np.asarray([5, 2], np.int32)
    jp = jcache.commit_prefill(jp, 1, jnp.asarray(pages), jpre, jpre.length)
    tp = tcache.commit_prefill(tp, 1, torch.from_numpy(pages), tpre, tpre.length)
    for _ in range(3):
        k, v = (rng.standard_normal((slots, 1, c)).astype(np.float32) for _ in range(2))
        jp = jp.append(jnp.asarray(k), jnp.asarray(v))
        tp = tp.append(torch.from_numpy(k), torch.from_numpy(v))
    k, v = (rng.standard_normal((slots, 2, c)).astype(np.float32) for _ in range(2))
    jp = jp.append_span(jnp.asarray(k), jnp.asarray(v))
    tp = tp.append_span(torch.from_numpy(k), torch.from_numpy(v))
    for name in ("k", "v", "page_table", "length"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(_bf16_bits(getattr(tp, name)), _bf16_bits(getattr(jp, name)), err_msg=name)
    for got, want in zip(tp.gather_view(), jp.gather_view()):
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jp = jcache.release_slot(jp, 1)
    tp = tcache.release_slot(tp, 1)
    assert tp.quantized and tp.page_table.tolist() == np.asarray(jp.page_table).tolist()
    fpool = tcache.init_paged_kv_cache(slots, 1 + slots * pps, page, pps, c, c, device="cpu")
    with pytest.raises(ValueError, match="prefill cache is int8"):
        tcache.commit_prefill(fpool, 0, torch.from_numpy(pages), tpre, tpre.length)
    fpre = tcache.init_kv_cache(1, 9, c, c, device="cpu")
    with pytest.raises(ValueError, match="paged cache is int8"):
        tcache.commit_prefill(tp, 0, torch.from_numpy(pages), fpre, 0)


def test_page_allocator_matches_jax_history():
    """The same alloc/free history gives the same grants, stats and audit in
    the port's copy and the JAX package's allocator."""
    rng = np.random.default_rng(3)
    jalloc, talloc = JaxPageAllocator(12, 4), PageAllocator(12, 4)
    jlive, tlive = [], []
    for _ in range(60):
        if jlive and rng.random() < 0.4:
            i = int(rng.integers(len(jlive)))
            assert talloc.free(tlive.pop(i)) == jalloc.free(jlive.pop(i))
        else:
            n = int(rng.integers(1, 14))
            jg, tg = jalloc.alloc_tokens(n), talloc.alloc_tokens(n)
            assert (jg is None) == (tg is None)
            if jg is not None:
                assert (tg.grant_id, tg.pages, tg.tokens) == (jg.grant_id, jg.pages, jg.tokens)
                jlive.append(jg)
                tlive.append(tg)
        assert vars(talloc.stats()) == vars(jalloc.stats())
    for g in tlive:
        talloc.free(g)
    assert talloc.pages_used == 0 and talloc.audit() == []
