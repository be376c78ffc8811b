"""The port's sampling filter (``generation._filtered_logits``) against the
JAX package's on the same numpy logits: temperature, top-k and top-p, with
the top-p cutoff at and past the end of the vocabulary (``top_p`` of 1.0,
whose f32 cumulative mass may end just below 1, and above 1), where the JAX
function keeps every entry.

Compared: the support (which entries are ``-inf``) exactly, and the kept
logits within 1e-6 (both divide by the same temperature in f32). The known
difference of contract is a rounding tie of the cumulative sum at the
cutoff: the two frameworks sum the sorted probabilities in another order,
so an entry whose preceding cumulative mass lies within a few f32 ulps of
``top_p`` may be kept by one and filtered by the other. At ``top_p=1.0``
that is most rows: the tail of a 262-entry softmax adds less than an ulp
per entry, so the f32 sums sit on a plateau at 1 +- a few ulps, and which
tail entries pass ``cum < 1`` is rounding. Such rows are named and held to
that explanation entry by entry, never left out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu_torch import generation as tgen

V = 262  # the byte vocabulary of the flagship CLM
TIE = 1e-6  # eight f32 ulps of a cumulative mass near 1: the two f32 sums of 262 terms may differ so


def _both(logits: np.ndarray, **cfg):
    got = tgen._filtered_logits(torch.from_numpy(logits), tgen.GenerationConfig(do_sample=True, **cfg)).numpy()
    want = np.asarray(jgen._filtered_logits(jnp.asarray(logits), jgen.GenerationConfig(do_sample=True, **cfg)))
    return got, want


def _tie_rows(scaled, got, want, top_p):
    """Rows whose supports differ. Sorted entry ``k`` is kept iff the mass
    before it, ``cum[k - 1]``, is below ``top_p``; so each entry that one
    package keeps and the other filters must have that mass (in f64, from
    ``scaled``: the logits after temperature and top-k) within ``TIE`` of
    ``top_p``, where the f32 sums of the two may fall on either side."""
    differ = np.flatnonzero((np.isinf(got) != np.isinf(want)).any(axis=-1))
    for r in differ:
        kept = sorted((int(np.isfinite(got[r]).sum()), int(np.isfinite(want[r]).sum())))
        x = np.sort(scaled[r].astype(np.float64))[::-1]
        p = np.exp(x - x.max())
        before = np.cumsum(p / p.sum())[kept[0] - 1:kept[1] - 1]
        assert np.abs(before - top_p).max() <= TIE, (r, kept, before)
    return differ


def test_seed_2_cumulative_mass_ends_below_one():
    """The logits whose f32 cumulative softmax ends below 1.0: with
    ``top_p=1.0`` every entry passes ``cum < top_p``, the cutoff index is the
    vocabulary size, and the JAX function keeps all entries."""
    torch.manual_seed(2)
    logits = (torch.randn(1, V) * 3).numpy()
    cum = torch.cumsum(torch.softmax(torch.sort(torch.from_numpy(logits), descending=True).values, -1), -1)
    assert float(cum[0, -1]) < 1.0
    got, want = _both(logits, top_p=1.0)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_k", [None, 20], ids=["top_p_alone", "with_top_k"])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0, 1.5])
def test_filtered_logits_match_jax(top_p, top_k):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((64, V)) * 3).astype(np.float32)
    got, want = _both(logits, top_p=top_p, top_k=top_k, temperature=0.8)
    scaled = np.asarray(jgen._filtered_logits(jnp.asarray(logits), jgen.GenerationConfig(top_k=top_k,
                                                                                          temperature=0.8)))
    ties = _tie_rows(scaled, got, want, top_p)
    same = np.setdiff1d(np.arange(len(logits)), ties)
    np.testing.assert_array_equal(np.isinf(got[same]), np.isinf(want[same]))
    finite = np.isfinite(got[same]) & np.isfinite(want[same])
    np.testing.assert_allclose(got[same][finite], want[same][finite], atol=1e-6, rtol=0)
    if top_p < 1.0:
        assert len(ties) <= 1, ties  # away from a mass of 1 a tie is rare
    if top_p > 1.0 and top_k is None:
        assert np.isfinite(got).all()  # a cutoff past the vocabulary filters nothing
    if top_k is not None:
        assert (np.isfinite(got).sum(axis=-1) <= top_k).all()


def test_sampling_with_top_p_past_the_vocabulary_draws():
    """``_sample`` at ``top_p`` 1.0 and 1.5 draws a token instead of raising
    (the cutoff used to index one past the sorted logits)."""
    torch.manual_seed(2)
    logits = torch.randn(1, V) * 3
    for top_p in (1.0, 1.5):
        cfg = tgen.GenerationConfig(do_sample=True, top_p=top_p)
        token = tgen._sample(logits, cfg, torch.Generator().manual_seed(0))
        assert token.shape == (1,) and 0 <= int(token[0]) < V
