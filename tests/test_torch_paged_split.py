"""K3's work partition (``paged_work_items``) and its split-and-merge
arithmetic in plain PyTorch (``split_model`` here): the partition covers
every valid page of every slot exactly once, in items that never cross a
slot, at most ``grid + S * groups`` of them, no CTA streaming more than
``chunk`` pages; the split version matches the JAX package's
``paged_decode_attention`` (its Pallas page-walk kernel in interpret mode)
and the port's plain version on every slot, a slot whose every valid token
is masked and a slot of length 0 included (both average the slot's whole
capacity). Attention tolerance: atol 1e-5 (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from perceiver_io_tpu.core import cache as jcache
from perceiver_io_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from perceiver_io_tpu_torch.core import cache as tcache
from perceiver_io_tpu_torch.ops.flash_attention import MASK_VALUE
from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_work_items


def split_model(qh, cache, mask=None, *, grid, groups=1):
    """K3's arithmetic in plain PyTorch: the partial (max, sum, acc) of each
    work item of ``paged_work_items`` per head, scores plus the finite
    ``MASK_VALUE`` where ``mask`` is set, then the merge of each slot's
    partials; where every valid token of a slot is masked, the tokens from
    its length to its capacity join at MASK_VALUE's weight, as the kernel's
    merge adds them; a slot with length 0 has no item, and its merge
    averages the whole capacity with weight 1. f32 throughout. ``qh``
    (S, H, Dk) -> (S, H, Dv)."""
    s_slots, h, d_qk = qh.shape
    d_v = cache.v.shape[2] // h
    page, cap = cache.page_size, cache.capacity
    gh = -(-h // groups)
    k_rows = cache.k.float().reshape(-1, h, d_qk)
    v_rows = cache.v.float().reshape(-1, h, d_v)
    lengths = [min(max(int(x), 0), cap) for x in cache.length.tolist()]
    table = cache.page_table.long()
    parts = {}
    for it in paged_work_items(lengths, page, grid, cap, groups):
        heads = slice(it.group * gh, min(h, (it.group + 1) * gh))
        t0 = it.first_page * page
        t1 = min((it.first_page + it.pages) * page, lengths[it.slot])
        t = torch.arange(t0, t1)
        rows = table[it.slot, t // page] * page + t % page
        scores = torch.einsum("gc,tgc->gt", qh[it.slot, heads].float(), k_rows[rows][:, heads])
        if mask is not None:
            scores = scores + torch.where(mask[it.slot, t0:t1], MASK_VALUE, 0.0)[None, :]
        m = scores.max(dim=1).values  # (g,)
        p = torch.exp(scores - m[:, None])
        parts.setdefault((it.slot, it.group), []).append((m, p.sum(dim=1), torch.einsum("gt,tgc->gc", p,
                                                                                        v_rows[rows][:, heads])))
    out = torch.zeros((s_slots, h, d_v), dtype=torch.float32)
    for s in range(s_slots):
        for g in range(groups):
            heads = slice(g * gh, min(h, (g + 1) * gh))
            n_h = heads.stop - heads.start
            items = parts.get((s, g))
            t = torch.arange(lengths[s], cap)
            tail = v_rows[table[s, t // page] * page + t % page][:, heads].sum(dim=0)  # (g, Dv)
            if items is None:  # length 0: every token of the capacity at weight 1
                out[s, heads] = tail / len(t)
                continue
            m = torch.stack([x[0] for x in items])  # (items, g)
            mx = m.max(dim=0).values
            w = torch.exp(m - mx)
            l_sum = (w * torch.stack([x[1] for x in items])).sum(dim=0)
            acc = (w[:, :, None] * torch.stack([x[2] for x in items])).sum(dim=0)
            w_tail = torch.where(mx < 0.5 * MASK_VALUE, torch.exp(MASK_VALUE - mx), torch.zeros(n_h))  # (g,)
            out[s, heads] = (acc + w_tail[:, None] * tail) / (l_sum + w_tail * len(t))[:, None]
    return out.to(qh.dtype)


def _check_partition(lengths, page, grid, capacity, groups):
    items = paged_work_items(lengths, page, grid, capacity, groups)
    clamp = [min(max(n, 0), capacity) for n in lengths]
    n_pages = [-(-n // page) for n in clamp]
    total = groups * sum(n_pages)
    chunk = -(-total // grid) if total else 0
    seen = {}
    per_cta = {}
    for it in items:
        assert it.pages >= 1 and it.first_page >= 0
        # an item never crosses a slot
        assert it.first_page + it.pages <= n_pages[it.slot]
        assert it.pages <= chunk
        assert 0 <= it.cta < grid and 0 <= it.group < groups
        for j in range(it.first_page, it.first_page + it.pages):
            key = (it.group, it.slot, j)
            assert key not in seen, f"page {key} covered twice"
            seen[key] = it
        per_cta[it.cta] = per_cta.get(it.cta, 0) + it.pages
    # every valid page of every slot (and head group) exactly once
    assert set(seen) == {(g, s, j) for g in range(groups) for s, n in enumerate(n_pages) for j in range(n)}
    assert len(items) <= grid + len(lengths) * groups
    # balanced: no CTA streams more than chunk pages
    assert all(n <= chunk for n in per_cta.values())
    # scratch rows are unique and inside the wrapper's (grid + S * groups)
    rows = [it.index for it in items]
    assert len(set(rows)) == len(rows)
    assert all(0 <= r < grid + len(lengths) * groups for r in rows)
    return items


@settings(max_examples=300, deadline=None)
@given(
    lengths=st.lists(st.integers(-3, 400), min_size=1, max_size=12),
    page=st.integers(1, 33),
    grid=st.integers(1, 300),
    pps=st.integers(1, 16),
    groups=st.integers(1, 3),
)
def test_work_items_cover_each_valid_page_once(lengths, page, grid, pps, groups):
    _check_partition(lengths, page, grid, page * pps, groups)


@pytest.mark.parametrize("lengths,page,grid", [
    ([0, 0, 0], 16, 132),            # no work: no item
    ([1, 0, 1, 0], 16, 132),         # length-1 slots: one page each, P_tot < grid
    ([1, 2085, 9000, 16320], 16, 132),  # the serve's CA case: 1715 pages, chunk 13
    ([513, 600, 777, 1024], 16, 132),   # the serve's SA case: 184 pages, chunk 2
    ([1, 1, 1, 16320], 16, 132),     # one long slot beside three one-token ones
    ([5, 7], 3, 1),                  # one CTA walks everything
])
def test_work_items_edge_cases(lengths, page, grid):
    cap = 16384 if max(lengths) > 1024 else 1024
    items = _check_partition(lengths, page, grid, cap, 1)
    if sum(lengths) == 0:
        assert items == []
    if lengths == [1, 2085, 9000, 16320]:
        # 1715 pages over 132 CTAs: every CTA streams 12 or 13 pages
        counts = {}
        for it in items:
            counts[it.cta] = counts.get(it.cta, 0) + it.pages
        assert len(counts) == 132 and set(counts.values()) <= {12, 13}


def test_work_items_clamp_lengths_past_capacity():
    """An idle slot's length grows past its capacity (its appends land in
    scratch): the walk reads at most the capacity."""
    items = paged_work_items([100, -1], 8, 4, capacity=32)
    assert sum(it.pages for it in items if it.slot == 0) == 4
    assert all(it.slot == 0 for it in items)


def _caches(rng, slots, page, pps, h, d, permute=True):
    num_pages = 1 + slots * pps
    k, v = (rng.standard_normal((num_pages, page, h * d)).astype(np.float32) for _ in range(2))
    ids = rng.permutation(num_pages - 1) + 1 if permute else np.arange(1, num_pages)
    table = ids.astype(np.int32).reshape(slots, pps)
    return k, v, table


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("geometry", ["micro", "ragged_permuted", "shared_pages", "head_groups"])
@pytest.mark.parametrize("grid", [1, 5, 132])
def test_split_reference_matches_jax(geometry, with_mask, grid):
    """The split-and-merge version against JAX's paged kernel (interpret
    mode): the micro geometry (4 heads of 32, page 8), ragged lengths over
    permuted pages, two slots naming the same pages, and two head groups;
    grids of 1, 5 and 132 CTAs cut the walk differently."""
    rng = np.random.default_rng(7)
    groups = 1
    if geometry == "micro":
        slots, page, pps, h, d = 2, 8, 4, 4, 32
        length = np.asarray([13, 32], np.int32)
    elif geometry == "ragged_permuted":
        slots, page, pps, h, d = 5, 8, 6, 4, 32
        length = np.asarray([1, 8, 9, 47, 0], np.int32)
    elif geometry == "shared_pages":
        slots, page, pps, h, d = 3, 8, 4, 8, 16
        length = np.asarray([20, 32, 17], np.int32)
    else:
        slots, page, pps, h, d = 3, 8, 3, 4, 32
        length = np.asarray([24, 5, 11], np.int32)
        groups = 2
    k, v, table = _caches(rng, slots, page, pps, h, d)
    if geometry == "shared_pages":
        table[2, :2] = table[0, :2]  # a shared prefix grant: slot 2 reads slot 0's first two pages
    table[length == 0] = 0  # a retired slot points at scratch
    jc = jcache.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), page_table=jnp.asarray(table),
                             length=jnp.asarray(length))
    tc = tcache.PagedKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v), page_table=torch.from_numpy(table),
                             length=torch.from_numpy(length))
    cap = pps * page
    q = (rng.standard_normal((slots, h, d)) * d**-0.5).astype(np.float32)
    validity = np.arange(cap)[None, :] >= length[:, None]
    pads = np.zeros((slots, cap), bool)
    if with_mask:
        pads[:, :2] = True  # two left pads a slot
        pads[0, : length[0]] = True  # slot 0: every valid token masked, a uniform average
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jc, jnp.asarray(validity | pads)))
    mask = torch.from_numpy(pads) if with_mask else None
    got = split_model(torch.from_numpy(q), tc, mask, grid=grid, groups=groups)
    # every slot, the retired one of length 0 included (the uniform average
    # of its capacity, the scratch page's values)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    plain = paged_attention_reference(torch.from_numpy(q), tc, mask)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    for s in np.flatnonzero(length == 0):
        np.testing.assert_allclose(got.numpy()[s], v[0].reshape(page, h, d).mean(axis=0), atol=1e-5, rtol=0)
    if with_mask:
        # slot 0, every valid token masked: a uniform average over its capacity
        rows = table[0, np.arange(cap) // page] * page + np.arange(cap) % page
        uniform = v.reshape(-1, h, d)[rows].mean(axis=0)
        np.testing.assert_allclose(got.numpy()[0], uniform, atol=1e-5, rtol=0)


def test_split_reference_odd_page_past_capacity():
    """Page size 3 with items that end mid-page at the length, and an idle
    slot whose length has grown past its capacity (it reads the capacity,
    as the plain version's validity mask does)."""
    rng = np.random.default_rng(11)
    slots, page, pps, h, d = 3, 3, 5, 4, 16
    k, v, table = _caches(rng, slots, page, pps, h, d)
    length = np.asarray([7, 40, 2], np.int32)
    tc = tcache.PagedKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v), page_table=torch.from_numpy(table),
                             length=torch.from_numpy(length))
    q = torch.from_numpy(rng.standard_normal((slots, h, d)).astype(np.float32))
    for grid in (1, 2, 7):
        got = split_model(q, tc, grid=grid)
        torch.testing.assert_close(got, paged_attention_reference(q, tc), atol=1e-5, rtol=0)
