"""Why K2 and K6 may run their f32 products on the tensor cores: a CPU model
of the kernels' split-TF32 arithmetic (``ops/csrc/flash_mma.cuh``) against
an f64 reference, at the main path's widths.

The model is test code, not port code. It rounds as the kernels do: each
f32 operand splits into ``big``, rounded as ``cvt.rna.tf32`` rounds (to
nearest, ties away from zero, to 10 stored mantissa bits), and the residual
``small = x - big``, of which the tensor core reads the top 10 mantissa
bits; each m16n8k8 product sums ``small.big + big.small + big.big`` in exact
arithmetic and
rounds the accumulator once per instruction, to nearest ("rn") or toward
zero ("rz", how the tensor core's f32 accumulation is documented to round);
score tiles sum at most four 8-wide k-steps in one accumulator, and each kv
tile's P.V starts from zero and joins the output with one f32 FMA. The
tolerances are the card's parity tolerances for K2: 1e-5 on the output,
1e-4 on the logsumexp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from perceiver_io_tpu_torch.ops.flash_attention import MASK_VALUE, packed_kv_splits

OUT_TOL, LSE_TOL = 1e-5, 1e-4
BKV, KG = 64, 4  # the kernels' kv tile and k-steps per fresh score accumulator


def rna_tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 stored mantissa bits, to
    nearest with ties away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc_tf32(x):
    """What the tensor core reads of an f32 operand: its low 13 bits
    cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, small="trunc"):
    """``big + small``: the kernels' split (``small`` as the tensor core
    reads the residual), or with the residual rounded too ("rna")."""
    big = rna_tf32(x)
    rest = np.float32(x) - big
    return big, rna_tf32(rest) if small == "rna" else trunc_tf32(rest)


def _round(x64, mode):
    r = x64.astype(np.float32)
    if mode == "rz":
        over = np.abs(r.astype(np.float64)) > np.abs(x64)
        r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma(a, b, c, mode):
    """One m16n8k8 instruction over a whole operand: c + a @ b (a (M, 8),
    b (8, N)) exact, then one rounding to f32."""
    return _round(c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64), mode)


def _chain(a, b, c, mode, passes=3, group=None, small="trunc"):
    """c + a @ b by 8-wide k-steps of ``passes`` TF32 products each (3: the
    split; 1: big x big alone), all chained into c; or, with ``group``, a
    fresh accumulator every ``group`` k-steps, the groups joined by f32
    adds (c unused)."""
    (ab, as_), (bb, bs) = split(a, small), split(b, small)

    def steps(acc, first, last):
        for s in range(first, last):
            k = slice(8 * s, 8 * s + 8)
            if passes == 3:
                acc = _mma(as_[:, k], bb[k], acc, mode)
                acc = _mma(ab[:, k], bs[k], acc, mode)
            acc = _mma(ab[:, k], bb[k], acc, mode)
        return acc

    n = a.shape[1] // 8
    if group is None:
        return steps(c, 0, n)
    out = None
    for g0 in range(0, n, group):
        acc = steps(np.zeros((a.shape[0], b.shape[1]), np.float32), g0, min(n, g0 + group))
        out = acc if out is None else (out + acc).astype(np.float32)
    return out


def tf32_flash(q, k, v, bias=None, offset=None, mode="rz", pv_passes=3, fresh_pv=True, small="trunc"):
    """The kernels' forward for one head: q (Nq, D), k (Nkv, D), v (Nkv, Dv),
    an additive bias row, key j visible to row i iff j <= i + offset (None:
    every key). Returns (o, lse)."""
    nq, nkv = q.shape[0], k.shape[0]
    bias = np.zeros(nkv, np.float32) if bias is None else bias
    m = np.full(nq, -np.inf, np.float32)
    l = np.zeros(nq, np.float32)
    o = np.zeros((nq, v.shape[1]), np.float32)
    i = np.arange(nq)[:, None]
    # the last tile zero-filled to BKV rows, its rows past nkv masked
    k, v = (np.concatenate([t, np.zeros((-nkv % BKV, t.shape[1]), np.float32)]) for t in (k, v))
    bias = np.concatenate([bias, np.zeros(-nkv % BKV, np.float32)])
    for j0 in range(0, nkv, BKV):
        kt, vt = k[j0:j0 + BKV], v[j0:j0 + BKV]
        s = _chain(q, kt.T.copy(), None, mode, group=KG, small=small)
        s = (s.astype(np.float64) + bias[None, j0:j0 + BKV]).astype(np.float32)
        j = j0 + np.arange(BKV)[None]
        visible = (j < nkv) & (True if offset is None else j <= i + offset)
        s = np.where(visible, s, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(axis=1))
        mu = np.where(np.isneginf(m_new), np.float32(0), m_new)
        alpha = np.exp(m - mu)
        p = np.exp(s - mu[:, None])
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        m = m_new
        if fresh_pv:
            tile = _chain(p, vt, np.zeros_like(o), mode, pv_passes, small=small)
            o = (o.astype(np.float64) * alpha[:, None] + tile).astype(np.float32)
        else:
            o = _chain(p, vt, (o * alpha[:, None]).astype(np.float32), mode, pv_passes, small=small)
    l_safe = np.where(l == 0, np.float32(1), l)
    return o / l_safe[:, None], m + np.log(l_safe)


def f64_attention(q, k, v, bias=None, offset=None):
    s = q.astype(np.float64) @ k.astype(np.float64).T
    if bias is not None:
        s = s + bias[None].astype(np.float64)
    if offset is not None:
        i, j = np.arange(q.shape[0])[:, None], np.arange(k.shape[0])[None]
        s = np.where(j <= i + offset, s, -np.inf)
    mx = s.max(axis=1, keepdims=True)
    p = np.exp(s - mx)
    return p @ v.astype(np.float64) / p.sum(axis=1, keepdims=True), (mx + np.log(p.sum(axis=1, keepdims=True)))[:, 0]


# the main path's widths: the image classifier's self-attention (D = 128 over
# 512 keys, non-causal; 64 query rows, one q block) and the serving prefill's
# cross-attention (D = 64 over 16384 keys, causal right-aligned; the last 16
# of its 512 latents, the rows with the longest walks)
SHAPES = {"image_sa": (128, 512, 64, False), "serve_ca": (64, 16384, 16, True)}


def _inputs(name, seed=0):
    d, nkv, rows, causal = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((rows, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((nkv, d)).astype(np.float32) for _ in range(2))
    # causal: these rows are the last of 512, so row r sees keys j <= r + nkv - 16
    return q, k, v, (nkv - rows if causal else None)


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # a TF32 ulp at 1
    x = np.array([1 + 2.0**-12, 1 + 2.0**-11, 1 + 3 * 2.0**-12, -(1 + 2.0**-11), 3.0], np.float32)
    want = np.array([one, one + ulp, one + ulp, -(one + ulp), 3.0], np.float32)
    np.testing.assert_array_equal(rna_tf32(x), want)
    big = rna_tf32(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()


@pytest.mark.parametrize("small,bits", [("trunc", 21), ("rna", 22)])
def test_big_plus_small_keeps_21_bits(small, bits):
    """The kernels' split keeps x to 2^-21 |x|; rounding the residual too
    would keep one bit more."""
    x = np.random.default_rng(2).standard_normal(100_000).astype(np.float32)
    big, rest = split(x, small)
    err = np.abs(x.astype(np.float64) - big.astype(np.float64) - rest.astype(np.float64))
    assert (err <= 2.0**-bits * np.abs(x)).all()
    assert (np.abs(x - big) > 2.0**-15 * np.abs(x)).any()  # one TF32 part alone does not


@pytest.mark.parametrize("small", ["trunc", "rna"])
@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_split_tf32_attention_meets_the_f32_tolerance(name, mode, small):
    """The kernels' arithmetic (``small`` as the tensor core reads it), and
    the split with the residual rounded as well, under either rounding of
    the accumulator."""
    q, k, v, offset = _inputs(name)
    o, lse = tf32_flash(q, k, v, offset=offset, mode=mode, small=small)
    ro, rlse = f64_attention(q, k, v, offset=offset)
    assert np.abs(o - ro).max() <= OUT_TOL
    assert np.abs(lse - rlse).max() <= LSE_TOL


@pytest.mark.parametrize("name", list(SHAPES))
def test_one_tf32_product_for_p_v_misses_the_tolerance(name):
    """P lies in [0, 1], but one TF32 product keeps ~2^-11 of each term:
    the output misses 1e-5 although the scores are split-TF32."""
    q, k, v, offset = _inputs(name)
    o, _ = tf32_flash(q, k, v, offset=offset, mode="rn", pv_passes=1)
    ro, _ = f64_attention(q, k, v, offset=offset)
    assert np.abs(o - ro).max() > OUT_TOL


def test_fresh_tile_accumulators_keep_the_walk_accurate():
    """Rounded toward zero, one accumulator chained over the serving
    prefill's 256 kv tiles drifts; a fresh accumulator per tile joined by a
    rounded-to-nearest FMA does not."""
    q, k, v, offset = _inputs("serve_ca")
    ro, _ = f64_attention(q, k, v, offset=offset)
    fresh = np.abs(tf32_flash(q, k, v, offset=offset, mode="rz")[0] - ro).max()
    chained = np.abs(tf32_flash(q, k, v, offset=offset, mode="rz", fresh_pv=False)[0] - ro).max()
    assert chained > 10 * fresh


@pytest.mark.parametrize("causal,nq,nkv,n_pad", [(True, 37, 203, 5), (False, 70, 130, 100), (True, 100, 100, 37)])
def test_the_model_agrees_with_the_jax_package(causal, nq, nkv, n_pad):
    """The model's semantics (right-aligned causal limit, the MASK_VALUE bias
    row, rows whose visible keys are all padded) are the JAX kernel's, run in
    interpret mode: per head, within the f32 tolerance. With every key of a
    row padded the JAX kernel's answer depends on its block size, so those
    rows are held to the uniform average of their visible keys instead."""
    h, d = 2, 64
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((1, nq, h * d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((1, nkv, h * d)).astype(np.float32) for _ in range(2))
    pad = np.zeros((1, nkv), bool)
    pad[0, :n_pad] = True
    want = np.asarray(jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h,
                                       pad_mask=jnp.asarray(pad), causal=causal))[0]
    bias = np.where(pad[0], np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    visible_real = (np.arange(nkv)[None] <= np.arange(nq)[:, None] + (offset if causal else nkv)) & ~pad[0][None]
    some_real = visible_real.any(axis=1)
    for hd in range(h):
        c = slice(hd * d, (hd + 1) * d)
        o, _ = tf32_flash(q[0][:, c], k[0][:, c], v[0][:, c], bias=bias, offset=offset)
        np.testing.assert_allclose(o[some_real], want[some_real, c], atol=OUT_TOL, rtol=0)
        for i in np.flatnonzero(~some_real):
            np.testing.assert_allclose(o[i], v[0][: i + offset + 1, c].mean(axis=0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,splits", [
    ((1, 8, 512, 16384, 64), 4),   # the serving prefill: 64 q blocks over 264 CTA slots
    ((2, 8, 1024, 8704, 64), 1),   # the CLM's training cross-attention: 256 q blocks
    ((16, 8, 512, 512, 128), 1),   # the image classifier's self-attention: 1024 q blocks
])
def test_k2_kv_split_at_the_main_path_shapes(shape, splits):
    assert packed_kv_splits(*shape, sms=132) == splits


@pytest.mark.parametrize("b,h,nq,nkv,d", [(1, 8, 512, 4100, 64), (1, 8, 512, 16384, 128), (3, 4, 200, 9000, 40),
                                         (1, 1, 64, 600, 64)])
def test_k2_kv_split_never_adds_a_wave(b, h, nq, nkv, d):
    """Two CTA slots an SM: a split fills the slots one CTA per q block
    leaves idle and never needs a second wave, and keeps at least 8 kv tiles
    (64 rows, 32 above head dim 64) a split."""
    n = packed_kv_splits(b, h, nq, nkv, d, 132)
    blocks = b * h * -(-nq // 64)
    assert n >= 1 and (n == 1 or n * blocks <= 2 * 132)
    assert n == 1 or -(-nkv // (64 if d <= 64 else 32)) >= 8 * n
