"""Why K2, K4a, K4b, K6, K7a, K7b, K8, K9a and K9b may run their f32
products on the tensor cores: a CPU model of the kernels' arithmetic
(``ops/csrc/flash_mma.cuh``: K2's and K6's split-TF32 forward, and K8's
over 48-row kv tiles, ``ops/csrc/flash_heads.cu``;
``ops/csrc/flash_mma_bwd.cuh``: K4a's and K4b's backward, f64 score
products, K4a's gradient products split-TF32 and K4b's in f64, and the
same bodies over two segments for K7a and K7b;
``ops/csrc/flash_heads_bwd.cu``: K9a's and K9b's heads-major backward,
every product in f64) against an f64 reference, at the main path's widths,
and the kv-split rules of K2 and K9b.

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
1e-4 on the logsumexp; for K4a/K4b: 1e-5 on every gradient; for K9a/K9b:
1e-5 on dK/dV, 6e-5 on dQ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from perceiver_io_tpu.ops.flash_attention import flash_attention_packed_2seg as jax_flash_packed_2seg
from perceiver_io_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    flash_attention_packed_bwd_reference,
    heads_dq_splits,
    packed_kv_splits,
)

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


def _chain(a, b, c, mode, passes=3, group=None, small="trunc", split_acc=False):
    """c + a @ b by 8-wide k-steps of ``passes`` TF32 products each (3: the
    split; 1: big x big alone), all chained into c; or, with ``group``, a
    fresh accumulator every ``group`` k-steps, the groups joined by f32
    adds (c unused). ``split_acc`` (K4a's and K7a's gradient products): the
    two cross terms and big x big in two fresh accumulators a group, their
    f32 sum the group's."""
    (ab, as_), (bb, bs) = split(a, small), split(b, small)

    def steps(acc, first, last):
        if split_acc and passes == 3:
            cross, big = acc, np.zeros_like(acc)
            for s in range(first, last):
                k = slice(8 * s, 8 * s + 8)
                cross = _mma(as_[:, k], bb[k], cross, mode)
                cross = _mma(ab[:, k], bs[k], cross, mode)
                big = _mma(ab[:, k], bb[k], big, mode)
            return (big + cross).astype(np.float32)
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


def tf32_flash(q, k, v, bias=None, offset=None, mode="rz", pv_passes=3, fresh_pv=True, small="trunc", bkv=BKV):
    """The kernels' forward for one head: q (Nq, D), k (Nkv, D), v (Nkv, Dv),
    an additive bias row, key j visible to row i iff j <= i + offset (None:
    every key), kv tiles of ``bkv`` rows. Returns (o, lse)."""
    nq, nkv = q.shape[0], k.shape[0]
    bias = np.zeros(nkv, np.float32) if bias is None else bias
    m = np.full(nq, -np.inf, np.float32)
    l = np.zeros(nq, np.float32)
    o = np.zeros((nq, v.shape[1]), np.float32)
    i = np.arange(nq)[:, None]
    # the last tile zero-filled to bkv rows, its rows past nkv masked
    k, v = (np.concatenate([t, np.zeros((-nkv % bkv, t.shape[1]), np.float32)]) for t in (k, v))
    bias = np.concatenate([bias, np.zeros(-nkv % bkv, np.float32)])
    for j0 in range(0, nkv, bkv):
        kt, vt = k[j0:j0 + bkv], v[j0:j0 + bkv]
        s = _chain(q, kt.T.copy(), None, mode, group=KG, small=small)
        s = (s.astype(np.float64) + bias[None, j0:j0 + bkv]).astype(np.float32)
        j = j0 + np.arange(bkv)[None]
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


# ---------------------------------------------------------------------------
# the backward: K4a (dK, dV) and K4b (dQ), ops/csrc/flash_packed_bwd.cu over
# flash_mma_bwd.cuh
# ---------------------------------------------------------------------------

# the four training shapes chip_smoke.py holds K4a/K4b to, per head: the
# CLM's cross-attention (1024 latents over 7680 kept prefix rows + the
# latents, causal), its latent self-attention, the cross-attention with 3001
# left-padded keys, and the image classifier's self-attention (non-causal).
# name: (head dim, nq, nkv, causal, left pads)
BWD_SHAPES = {
    "ca": (64, 1024, 8704, True, 0),
    "sa": (64, 1024, 1024, True, 0),
    "ca_leftpad": (64, 1024, 8704, True, 3001),
    "image_sa": (128, 512, 512, False, 0),
}


def _walk_rows(d):
    """Rows of a walked tile: K4b's kv tiles and K4a's q tiles, 64 up to head
    dim 64 and 32 above."""
    return 64 if d <= 64 else 32


def _pad_rows(x, rows):
    return np.concatenate([x, np.zeros((-x.shape[0] % rows,) + x.shape[1:], x.dtype)])


def _grad(a, b, o, mode, passes, group, small, split_acc=False):
    """o + a @ b as the gradient products add: ``group`` k-steps a fresh
    accumulator (two with ``split_acc``), each joined to o by an f32 add; or
    (``group`` None) every k-step chained into o itself."""
    if group is None:
        return _chain(a, b, o, mode, passes, small=small)
    for g0 in range(0, a.shape[1], 8 * group):
        k = slice(g0, g0 + 8 * group)
        o = (o + _chain(a[:, k], b[k], np.zeros_like(o), mode, passes, small=small,
                        split_acc=split_acc)).astype(np.float32)
    return o


def _scores(a, b, f64, mode, passes, kg, small):
    """A B^T as the kernels' score products take it: in f64 (the tensor
    core's f64 products are exact and their sums f64; ``f64``) or split-TF32
    with ``kg`` k-steps a fresh accumulator."""
    if f64:
        return a.astype(np.float64) @ b.T.astype(np.float64)
    return _chain(a, b.T.copy(), None, mode, passes, group=kg or 1, small=small)


def tf32_flash_bwd_dq(q, k, v, do, lse, delta, rows, bias, offset, mode="rz", passes=3, kg=1, f64=True,
                      small="trunc", grad64=True):
    """K4b for the q rows ``rows`` of one head (sm_scale 1): per kv tile,
    S = Q K^T and dP = dO V^T in f64 (``f64``; else split-TF32), the
    exponent s + bias - lse and dP - delta in the products' precision, then
    rounded to f32; p = exp in f32, dS = p (dP - delta) in f32; and
    dQ += dS K in f64 over the whole walk, rounded to f32 once at the end
    (``grad64``; else split-TF32, ``kg`` k-steps a fresh accumulator joined
    by an f32 add, chained over the whole walk for ``kg`` None)."""
    nkv, walk = k.shape[0], _walk_rows(q.shape[1])
    qr, dor, lr, dr = q[rows], do[rows], lse[rows][:, None], delta[rows][:, None]
    kp, vp, bp = _pad_rows(k, walk), _pad_rows(v, walk), _pad_rows(bias, walk)
    dq = np.zeros(qr.shape, np.float64 if grad64 else np.float32)
    for j0 in range(0, nkv, walk):
        kt, vt = kp[j0:j0 + walk], vp[j0:j0 + walk]
        s = _scores(qr, kt, f64, mode, passes, kg, small)
        dp = _scores(dor, vt, f64, mode, passes, kg, small)
        x = (s + bp[None, j0:j0 + walk] - lr).astype(np.float32)
        j = j0 + np.arange(walk)[None]
        visible = (j < nkv) & (True if offset is None else j <= rows[:, None] + offset)
        p = np.exp(np.where(visible, x, np.float32(-np.inf)))
        ds = (p * (dp - dr).astype(np.float32)).astype(np.float32)
        if grad64:
            dq += ds.astype(np.float64) @ kt.astype(np.float64)
        else:
            dq = _grad(ds, kt, dq, mode, passes, kg, small)
    return dq.astype(np.float32)


def tf32_flash_bwd_dkv(q, k, v, do, lse, delta, rows, bias, offset, mode="rz", passes=3, kg=(1, 2), f64=True,
                       small="trunc", split_acc=True):
    """K4a for the kv rows ``rows`` of one head (sm_scale 1), transposed: per
    q tile, S^T = K Q^T and dP^T = V dO^T in f64 (``f64``; else split-TF32
    with ``kg[0]`` k-steps a fresh accumulator), p and dS with lse and delta
    per column as in :func:`tf32_flash_bwd_dq`, and dV += P^T dO and
    dK += dS^T Q split-TF32 with ``kg[1]`` k-steps a fresh accumulator (2,
    as the kernels; "tile": one walked tile; None: chained over the walk),
    the cross terms and big x big apart (``split_acc``, as the kernels)."""
    nq, walk = q.shape[0], _walk_rows(q.shape[1])
    kr, vr, br = k[rows], v[rows], bias[rows][:, None]
    qp, dop, lp, dp_ = _pad_rows(q, walk), _pad_rows(do, walk), _pad_rows(lse, walk), _pad_rows(delta, walk)
    dk, dv = np.zeros_like(kr), np.zeros((len(rows), v.shape[1]), np.float32)
    for i0 in range(0, nq, walk):
        qt, dot = qp[i0:i0 + walk], dop[i0:i0 + walk]
        st = _scores(kr, qt, f64, mode, passes, kg[0], small)
        dpt = _scores(vr, dot, f64, mode, passes, kg[0], small)
        # the exponent in f64 (as the scores) and its exp rounded to f32 once
        x = st + br.astype(np.float64) - lp[None, i0:i0 + walk].astype(np.float64)
        i = i0 + np.arange(walk)[None]
        visible = (i < nq) & (True if offset is None else rows[:, None] <= i + offset)
        p = np.exp(np.where(visible, x, -np.inf)).astype(np.float32)
        ds = (p * (dpt - dp_[None, i0:i0 + walk]).astype(np.float32)).astype(np.float32)
        group = walk // 8 if kg[1] == "tile" else kg[1]
        dv = _grad(p, dot, dv, mode, passes, group, small, split_acc)
        dk = _grad(ds, qt, dk, mode, passes, group, small, split_acc)
    return dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_case(name):
    """One head of a training shape, drawn as chip_smoke.py draws it; the
    forward's f32 lse and delta = rowsum(dO * O) from an f64 forward; the
    rows the model computes (the first and last 16 q rows: the shortest and
    longest causal walks; the first and last 16 kv rows and the first 16
    unpadded ones: the longest walks, the largest p); and the f64 gradients
    of those rows from the same f32 inputs."""
    d, nq, nkv, causal, pads = BWD_SHAPES[name]
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((nq, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((nkv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((nq, d)).astype(np.float32)
    bias = np.where(np.arange(nkv) < pads, np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    o, lse = f64_attention(q, k, v, bias=bias, offset=offset)
    lse = lse.astype(np.float32)
    delta = (do.astype(np.float64) * o).sum(axis=1).astype(np.float32)
    rows_q = np.r_[0:16, nq - 16:nq]
    rows_kv = np.unique(np.r_[0:16, pads:pads + 16, nkv - 16:nkv])

    def p64(qi, kj):
        s = q[qi].astype(np.float64) @ k[kj].astype(np.float64).T + bias[kj][None].astype(np.float64)
        visible = True if offset is None else kj[None] <= qi[:, None] + offset
        return np.where(visible, np.exp(s - lse[qi][:, None].astype(np.float64)), 0.0)

    p = p64(rows_q, np.arange(nkv))
    ds = p * (do[rows_q].astype(np.float64) @ v.astype(np.float64).T - delta[rows_q][:, None])
    pt = p64(np.arange(nq), rows_kv).T
    dst = pt * (v[rows_kv].astype(np.float64) @ do.astype(np.float64).T - delta[None].astype(np.float64))
    want = {"dq": ds @ k.astype(np.float64), "dk": dst @ q.astype(np.float64), "dv": pt @ do.astype(np.float64)}
    return (q, k, v, do, lse, delta, bias, offset), rows_q, rows_kv, want


def _bwd_errors(name, dq_model=None, dkv_model=None):
    """Largest error of the model's dQ, dK, dV rows against f64."""
    args, rows_q, rows_kv, want = _bwd_case(name)
    dq = tf32_flash_bwd_dq(*args[:6], rows_q, *args[6:], **(dq_model or {}))
    dk, dv = tf32_flash_bwd_dkv(*args[:6], rows_kv, *args[6:], **(dkv_model or {}))
    return {g: float(np.abs(x - want[g]).max()) for g, x in (("dq", dq), ("dk", dk), ("dv", dv))}


def _f32_plain_errors(name):
    """The same rows from the port's plain backward in f32 on the CPU (an
    f32 evaluation of the same function: what the model is compared with)."""
    args, rows_q, rows_kv, want = _bwd_case(name)
    q, k, v, do, lse, delta, bias, offset = args
    o, _ = f64_attention(q, k, v, bias=bias, offset=offset)
    pad = torch.from_numpy(bias < 0)[None]
    got = flash_attention_packed_bwd_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v, o.astype(np.float32))), torch.from_numpy(lse)[None, :, None],
        torch.from_numpy(do)[None], 1, pad_mask=pad, causal=offset is not None)
    got = {"dq": got[0][0].numpy()[rows_q], "dk": got[1][0].numpy()[rows_kv], "dv": got[2][0].numpy()[rows_kv]}
    return {g: float(np.abs(got[g] - want[g]).max()) for g in got}


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_the_backward_meets_a_third_of_the_tolerance(name):
    """The kernels' arithmetic (S and dP, or S^T and dP^T, in f64 on the
    tensor cores; K4b's dQ += dS K in f64 too; K4a's dV and dK split-TF32
    with a fresh accumulator every two k-steps, rounded toward zero and
    joined by f32 adds) holds every gradient within 3e-6 of f64, a third of
    the card's 1e-5 tolerance; the port's plain backward in f32 is reported
    beside it."""
    got, plain = _bwd_errors(name), _f32_plain_errors(name)
    for g in got:
        assert got[g] <= 3e-6, (g, got[g], plain[g])


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_one_tf32_product_misses_the_backward_tolerance(name):
    """Without the split (big x big alone) in the gradient products, K4a's
    dK and dV leave the third of the tolerance that the model is held to at
    every shape (and miss 1e-5 itself at all but the cross-attention, where
    they reach 8.3e-6), and dQ summed that way instead of in f64 misses 1e-5
    by 18x at the cross-attention, by 300x at the latent self-attention."""
    got = _bwd_errors(name, dq_model=dict(grad64=False, passes=1), dkv_model=dict(passes=1))
    assert max(got["dk"], got["dv"]) > OUT_TOL / 3, got
    assert got["dq"] > 10 * OUT_TOL, got


@pytest.mark.parametrize("name", ["ca", "sa"])
def test_gradients_chained_over_the_walk_drift(name):
    """Split-TF32 gradients summed in one accumulator chained over the whole
    walk (toward zero, every mma at the running sum's magnitude) are several
    times worse than the kernels' sums (K4a's fresh accumulators, K4b's f64
    one), and miss the tolerance on the longest walks."""
    fresh = _bwd_errors(name)
    chained = _bwd_errors(name, dq_model=dict(grad64=False, kg=None), dkv_model=dict(kg=(1, None)))
    assert max(chained.values()) > 4 * max(fresh.values()), (fresh, chained)
    assert max(chained.values()) > OUT_TOL


def test_f64_scores_beat_split_tf32_scores_on_the_largest_gradients():
    """At the latent self-attention, where |dQ| reaches 10, split-TF32 S and
    dP (a fresh accumulator per k-step) leave dQ beyond a third of the
    tolerance: S and dP in f64 (what the kernels run) cut its error by more
    than a third."""
    split = _bwd_errors("sa", dq_model=dict(f64=False), dkv_model=dict(f64=False))["dq"]
    f64 = _bwd_errors("sa")["dq"]
    assert split > OUT_TOL / 3 and f64 <= 2 * split / 3, (f64, split)


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_dq_in_f64_beats_split_tf32_dq(name):
    """K4b sums dQ += dS K in f64 on the tensor cores rather than
    split-TF32 with a fresh accumulator per k-step: its dQ error falls to
    at most 0.6x the split form's at every shape (0.19x at the
    cross-attention, 0.55x at the latent self-attention)."""
    f64 = _bwd_errors(name)["dq"]
    split = _bwd_errors(name, dq_model=dict(grad64=False))["dq"]
    assert f64 <= 0.6 * split, (f64, split)


@pytest.mark.parametrize("causal,nq,nkv,n_pad", [(True, 37, 203, 5), (False, 70, 130, 10), (True, 100, 100, 0)])
def test_the_backward_model_agrees_with_the_jax_package(causal, nq, nkv, n_pad):
    """The model's dQ, dK, dV (right-aligned causal limit, the MASK_VALUE bias
    row, lengths that are no tile multiple) against the JAX package's packed
    VJP, whose Pallas backward kernels run in interpret mode, per head,
    within the f32 tolerance. Every row sees a real key."""
    h, d = 2, 64
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((1, nq, h * d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((1, nkv, h * d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((1, nq, h * d)).astype(np.float32)
    pad = np.zeros((1, nkv), bool)
    pad[0, :n_pad] = True
    with default_flash(True):
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_packed(q_, k_, v_, num_heads=h, pad_mask=jnp.asarray(pad),
                                                              causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g)[0] for g in vjp(jnp.asarray(do))]
    bias = np.where(pad[0], np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    for hd in range(h):
        c = slice(hd * d, (hd + 1) * d)
        qh, kh, vh, doh = q[0][:, c], k[0][:, c], v[0][:, c], do[0][:, c]
        o, lse = f64_attention(qh, kh, vh, bias=bias, offset=offset)
        delta = (doh.astype(np.float64) * o).sum(axis=1).astype(np.float32)
        args = (qh, kh, vh, doh, lse.astype(np.float32), delta)
        dq = tf32_flash_bwd_dq(*args, np.arange(nq), bias, offset)
        dk, dv = tf32_flash_bwd_dkv(*args, np.arange(nkv), bias, offset)
        for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
            np.testing.assert_allclose(got, w[:, c], atol=OUT_TOL, rtol=0, err_msg=f"{name} head {hd}")


# ---------------------------------------------------------------------------
# the two-segment backward: K7a / K7b, ops/csrc/flash_2seg_bwd.cu on K4's
# bodies (flash_mma_bwd.cuh), the kv sequence read as [prefix; latents]
# ---------------------------------------------------------------------------


def twoseg_bwd_model(q, k_p, v_p, k_l, v_l, do, lse, delta, bias_p, bias_l):
    """K7b's dQ and K7a's dK, dV of each segment for one head (sm_scale 1):
    K4's arithmetic over two segments, each cut into its own walked tiles
    (no tile straddles the seam; each segment's last tile zero-filled and
    masked past its rows): the prefix's tiles visible to every query, the
    latents' causal at offset 0, each segment with its own bias row. dQ sums
    both segments' tiles in f64 and rounds once; the blocks of dK/dV never
    straddle the seam either (``tf32_flash_bwd_dkv`` per segment). Returns
    (dq, dk_p, dv_p, dk_l, dv_l)."""
    nq, walk = q.shape[0], _walk_rows(q.shape[1])
    rows = np.arange(nq)
    lr, dr = lse[:, None], delta[:, None]
    segments = ((k_p, v_p, bias_p, None), (k_l, v_l, bias_l, 0))
    dq = np.zeros(q.shape, np.float64)
    for k, v, bias, offset in segments:
        n = k.shape[0]
        kp, vp, bp = _pad_rows(k, walk), _pad_rows(v, walk), _pad_rows(bias, walk)
        for j0 in range(0, n, walk):
            kt, vt = kp[j0:j0 + walk], vp[j0:j0 + walk]
            s = q.astype(np.float64) @ kt.T.astype(np.float64)
            dp = do.astype(np.float64) @ vt.T.astype(np.float64)
            x = (s + bp[None, j0:j0 + walk] - lr).astype(np.float32)
            j = j0 + np.arange(walk)[None]
            visible = (j < n) & (True if offset is None else j <= rows[:, None] + offset)
            p = np.exp(np.where(visible, x, np.float32(-np.inf)))
            ds = (p * (dp - dr).astype(np.float32)).astype(np.float32)
            dq += ds.astype(np.float64) @ kt.astype(np.float64)
    grads = [dq.astype(np.float32)]
    for k, v, bias, offset in segments:
        grads += tf32_flash_bwd_dkv(q, k, v, do, lse, delta, np.arange(k.shape[0]), bias, offset)
    return tuple(grads)


def test_two_k_steps_a_fresh_accumulator_cut_the_short_walk_error():
    """At a short walk (one prefix row and 100 latents, head dim 64, as the
    card's test_flash_2seg_kernels_match_plain draws it), one fresh
    split-TF32 accumulator a walked tile (8 k-steps, each mma truncating the
    running sum toward zero) leaves K7a's dK/dV 3.2e-6 from f64, further
    than the f32 plain version on the card (2.6e-6); a fresh accumulator
    every two k-steps, what K4a and K7a run, cuts that by more than half."""
    d, nq = 64, 100
    g = torch.Generator().manual_seed(6)
    q, k_l, v_l = (torch.randn(2, nq, 4 * d, generator=g) for _ in range(3))
    k_p, v_p = (torch.randn(2, 1, 4 * d, generator=g) for _ in range(2))
    do = torch.randn(2, nq, 4 * d, generator=g)
    c = slice(0, d)
    qh = (q[0][:, c].numpy().astype(np.float64) * d**-0.5).astype(np.float32)
    kph, vph, klh, vlh, doh = (x[0][:, c].numpy() for x in (k_p, v_p, k_l, v_l, do))
    k_cat, v_cat = np.concatenate([kph, klh]), np.concatenate([vph, vlh])
    o, lse = f64_attention(qh, k_cat, v_cat, offset=1)
    lse = lse.astype(np.float32)
    delta = (doh.astype(np.float64) * o.astype(np.float32)).sum(axis=1).astype(np.float32)
    s = qh.astype(np.float64) @ k_cat.T.astype(np.float64)
    p = np.where(np.arange(1 + nq)[None] <= np.arange(nq)[:, None] + 1, np.exp(s - lse[:, None]), 0.0)
    ds = p * (doh.astype(np.float64) @ v_cat.T.astype(np.float64) - delta[:, None].astype(np.float64))
    want = (ds.T @ qh.astype(np.float64))[1:], (p.T @ doh.astype(np.float64))[1:]
    errs = {}
    for kg in ("tile", 2):
        got = tf32_flash_bwd_dkv(qh, klh, vlh, doh, lse, delta, np.arange(nq), np.zeros(nq, np.float32), 0,
                                 kg=(1, kg))
        errs[kg] = max(float(np.abs(x - w).max()) for x, w in zip(got, want))
    assert errs[2] <= errs["tile"] / 2, errs


# name: (head dim, prefix rows, latents, left-padded prefix keys): the
# minimum prefix (one row), the seam inside a walked tile with left pads,
# Nq no tile multiple, a prefix of two tiles and a row mostly padded
TWOSEG_CASES = {
    "min_prefix": (64, 1, 100, 0),
    "seam_in_tile_pads": (64, 70, 130, 5),
    "one_tile_and_a_row_padded": (32, 129, 37, 100),
    "d128_seam": (128, 200, 77, 3),
}


@pytest.mark.parametrize("name", list(TWOSEG_CASES))
def test_the_twoseg_backward_model_agrees_with_the_jax_package_and_f64(name):
    """The two-segment model's dQ and per-segment dK, dV against the JAX
    package's ``flash_attention_packed_2seg`` VJP (its Pallas kernels
    ``_dkv_2seg_kernel`` and ``_dq_2seg_kernel`` in interpret mode) and
    against the gradients in f64 over the joined segments, per head, within
    the f32 tolerance (1e-5)."""
    d, n_p, nq, n_pad = TWOSEG_CASES[name]
    h = 2
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((1, nq, h * d)) * d**-0.5).astype(np.float32)
    k_p, v_p = (rng.standard_normal((1, n_p, h * d)).astype(np.float32) for _ in range(2))
    k_l, v_l = (rng.standard_normal((1, nq, h * d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((1, nq, h * d)).astype(np.float32)
    pad_p = np.zeros((1, n_p), bool)
    pad_p[0, :n_pad] = True
    with default_flash(True):
        _, vjp = jax.vjp(lambda *t: jax_flash_packed_2seg(*t, num_heads=h, pad_mask_prefix=jnp.asarray(pad_p)),
                         *map(jnp.asarray, (q, k_p, v_p, k_l, v_l)))
        want_jax = [np.asarray(g)[0] for g in vjp(jnp.asarray(do))]
    bias_p = np.where(pad_p[0], np.float32(MASK_VALUE), np.float32(0))
    bias_l = np.zeros(nq, np.float32)
    for hd in range(h):
        c = slice(hd * d, (hd + 1) * d)
        qh, kph, vph, klh, vlh, doh = (x[0][:, c] for x in (q, k_p, v_p, k_l, v_l, do))
        k_cat, v_cat, b_cat = np.concatenate([kph, klh]), np.concatenate([vph, vlh]), np.concatenate([bias_p, bias_l])
        o, lse = f64_attention(qh, k_cat, v_cat, bias=b_cat, offset=n_p)
        delta = (doh.astype(np.float64) * o).sum(axis=1).astype(np.float32)
        got = twoseg_bwd_model(qh, kph, vph, klh, vlh, doh, lse.astype(np.float32), delta, bias_p, bias_l)
        # f64 gradients over the joined segments from the same f32 inputs
        s = qh.astype(np.float64) @ k_cat.T.astype(np.float64) + b_cat[None].astype(np.float64)
        visible = np.arange(n_p + nq)[None] <= np.arange(nq)[:, None] + n_p
        p = np.where(visible, np.exp(s - lse.astype(np.float32)[:, None].astype(np.float64)), 0.0)
        ds = p * (doh.astype(np.float64) @ v_cat.T.astype(np.float64) - delta[:, None].astype(np.float64))
        dk, dv = ds.T @ qh.astype(np.float64), p.T @ doh.astype(np.float64)
        want64 = (ds @ k_cat.astype(np.float64), dk[:n_p], dv[:n_p], dk[n_p:], dv[n_p:])
        names = ("dq", "dk_prefix", "dv_prefix", "dk_latent", "dv_latent")
        for g_name, x, w64, wj in zip(names, got, want64, want_jax):
            np.testing.assert_allclose(x, w64, atol=OUT_TOL, rtol=0, err_msg=f"{g_name} head {hd} (f64)")
            np.testing.assert_allclose(x, wj[:, c], atol=OUT_TOL, rtol=0, err_msg=f"{g_name} head {hd} (JAX)")


# ---------------------------------------------------------------------------
# the heads-major forward: K8, ops/csrc/flash_heads.cu
# ---------------------------------------------------------------------------

K8_BKV = 48  # K8's kv rows a tile up to head dim 288 (the fresh P.V accumulators' span)

# chip_smoke.py's heads-major forward cases that the model covers, one head
# each: name: (head dim, the kernel's (zero-padded) head dim, nq, nkv,
# causal, left pads). The image classifier's cross-attention at a reduced
# key count (all 512 latents, 2048 of its 50176 pixels; head dim 264 is 33
# k-steps, 9 score chains) and the causal / pad / Nq > Nkv / d12 edges.
K8_SHAPES = {
    "image_ca_2048_keys": (264, 264, 512, 2048, False, 0),
    "d12_causal_pad": (12, 16, 130, 300, True, 37),
    "d133_causal_pad": (133, 136, 130, 300, True, 37),
    "d264_full_pad": (264, 264, 130, 300, False, 37),
    "nq_gt_nkv_causal": (40, 40, 300, 130, True, 0),
}


def k8_model(q, k, v, bias, offset):
    """K8's forward for one head: split-TF32 score products in chains of KG
    k-steps (each a fresh accumulator rounded toward zero, the chains joined
    by f32 adds), the online softmax in f32 over 48-row kv tiles, each
    tile's P V (split-TF32, rounded toward zero) in a fresh accumulator
    joined by one f32 FMA with the rescale."""
    return tf32_flash(q, k, v, bias=bias, offset=offset, mode="rz", bkv=K8_BKV)


@pytest.mark.parametrize("name", list(K8_SHAPES))
def test_k8_model_meets_the_f32_tolerance(name):
    """K8's arithmetic holds the output within the card's 1e-5 and the
    logsumexp within 1e-4 of the plain version evaluated in f64, at the
    image classifier's head dim over 2048 keys (43 tiles) and at the edge
    cases; a row that sees no key (Nq > Nkv, causal) gets 0 and logsumexp
    -inf."""
    d, d8, nq, nkv, causal, pads = K8_SHAPES[name]
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((nq, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((nkv, d)).astype(np.float32) for _ in range(2))
    q, k, v = (np.pad(t, ((0, 0), (0, d8 - d))) for t in (q, k, v))
    bias = np.where(np.arange(nkv) < pads, np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    o, lse = k8_model(q, k, v, bias, offset)
    sees = np.arange(nq) + (offset if causal else nkv) >= 0
    ro, rlse = f64_attention(q[sees], k, v, bias=bias, offset=None if offset is None else offset + np.flatnonzero(sees)[0])
    assert np.abs(o[sees] - ro).max() <= OUT_TOL
    assert np.abs(lse[sees] - rlse).max() <= LSE_TOL
    assert not o[~sees].any() and np.isneginf(lse[~sees]).all()


@pytest.mark.parametrize("d,causal,nq,nkv,n_pad", [(40, True, 70, 203, 5), (133, False, 45, 130, 10),
                                                   (264, False, 64, 150, 0), (12, True, 100, 100, 0)])
def test_k8_model_agrees_with_the_jax_package(d, causal, nq, nkv, n_pad):
    """The model's output (right-aligned causal limit, the MASK_VALUE bias
    row, lengths that are no tile multiple, head dims the wrapper zero-pads)
    against the JAX package's heads-major ``flash_attention``, whose Pallas
    forward runs in interpret mode, per head, within 1e-5. Every row sees a
    real key."""
    from perceiver_io_tpu.ops.flash_attention import flash_attention as jax_flash

    h, d8 = 2, -(-d // 8) * 8
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((1, h, nq, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((1, h, nkv, d)).astype(np.float32) for _ in range(2))
    pad = np.zeros((1, nkv), bool)
    pad[0, :n_pad] = True
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad_mask=jnp.asarray(pad),
                                causal=causal))[0]
    bias = np.where(pad[0], np.float32(MASK_VALUE), np.float32(0))
    for hd in range(h):
        qh, kh, vh = (np.pad(t[0, hd], ((0, 0), (0, d8 - d))) for t in (q, k, v))
        o, _ = k8_model(qh, kh, vh, bias, nkv - nq if causal else None)
        np.testing.assert_allclose(o[:, :d], want[hd], atol=OUT_TOL, rtol=0, err_msg=f"head {hd}")


# ---------------------------------------------------------------------------
# the heads-major backward: K9a (dK, dV) and K9b (dQ),
# ops/csrc/flash_heads_bwd.cu
# ---------------------------------------------------------------------------

# chip_smoke.py's heads-major backward shapes that the model covers, per
# head: name: (head dim, the kernel's (zero-padded) head dim, nq, nkv,
# causal, left pads, batch x heads). The image classifier's cross-attention
# at batch 16 (the main path), and three edge cases of heads_phase.
K9_SHAPES = {
    "image_ca": (264, 264, 512, 50176, False, 0, 16),
    "d133_causal_pad": (133, 136, 130, 300, True, 37, 4),
    "d512_causal": (512, 512, 130, 300, True, 0, 4),
    "split_walk_causal_pad": (136, 136, 100, 3000, True, 50, 4),
}
K9_DKV_TOL, K9_DQ_TOL = 1e-5, 6e-5  # chip_smoke.py's tolerances


def _k9_rows(d):
    """Rows of K9a's and K9b's blocks and walked tiles."""
    return 32 if d <= 288 else 16


def _exp64(x):
    """The kernels' p from an f64 exponent: expf of the exponent rounded to
    f32, corrected by the rounding's residual with one f32 FMA."""
    xf = x.astype(np.float32)
    p = np.exp(xf)
    with np.errstate(invalid="ignore"):
        lo = (x - xf.astype(np.float64)).astype(np.float32).astype(np.float64)
    return np.where(np.isinf(xf), p, (p.astype(np.float64) * (1 + lo)).astype(np.float32))


def k9_model(q, k, v, do, lse, delta, bias, offset, rows_q, rows_kv, nsplit=1, scores="f64", grads="f64",
             exp="exp64"):
    """K9b's dQ rows ``rows_q`` and K9a's dK, dV rows ``rows_kv`` of one
    head (sm_scale 1), as the kernels compute them: S and dP (S^T and dP^T)
    in f64 (``scores="tf32"``: split-TF32, KG k-steps a fresh accumulator,
    rounded toward zero), the exponent s + bias - lse and dP - delta in the
    products' precision, p = exp of the exponent (``exp="exp64"``: corrected
    for its f32 rounding; "expf": not), dS = p (dP - delta) rounded to f32
    once; the gradient products in f64 over the whole walk, rounded to f32
    once (``grads="tf32"``: split-TF32 with a fresh accumulator per walked
    tile, rounded toward zero and joined by f32 adds); K9b's walk split
    ``nsplit`` ways by tiles, the f32 partials summed in split order."""
    nq, nkv, d = q.shape[0], k.shape[0], q.shape[1]
    walk = _k9_rows(d)
    qp, dop, lp, dp_ = _pad_rows(q, walk), _pad_rows(do, walk), _pad_rows(lse, walk), _pad_rows(delta, walk)
    kp, vp, bp = _pad_rows(k, walk), _pad_rows(v, walk), _pad_rows(bias, walk)

    def prod(a, b):
        return _scores(a, b, scores == "f64", "rz", 3, KG, "trunc").astype(np.float64)

    def p_ds(qi, kj):
        x = prod(qp[qi], kp[kj]) + bp[kj][None].astype(np.float64) - lp[qi][:, None].astype(np.float64)
        visible = (qi[:, None] < nq) & (kj[None] < nkv) & (True if offset is None else kj[None] <= qi[:, None] + offset)
        x = np.where(visible, x, -np.inf)
        p = _exp64(x) if exp == "exp64" else np.exp(x.astype(np.float32))
        ds = (p.astype(np.float64) * (prod(dop[qi], vp[kj]) - dp_[qi][:, None].astype(np.float64))).astype(np.float32)
        return p, ds

    def grad(a, b):
        if grads == "f64":
            return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
        return _grad(a, b, np.zeros((a.shape[0], b.shape[1]), np.float32), "rz", 3, walk // 8, "trunc")

    _, ds = p_ds(rows_q, np.arange(kp.shape[0]))
    dq = np.zeros((len(rows_q), d), np.float32)
    for r, i in enumerate(rows_q):
        q0 = i - i % walk
        kv_end = nkv if offset is None else max(0, min(nkv, min(q0 + walk, nq) + offset))
        n_tiles = -(-kv_end // walk)
        per = -(-n_tiles // nsplit)
        for z in range(nsplit):
            cols = slice(min(n_tiles, z * per) * walk, min(n_tiles, z * per + per) * walk)
            dq[r] = (dq[r] + grad(ds[r:r + 1, cols], kp[cols])[0]).astype(np.float32)
    pt, dst = p_ds(np.arange(qp.shape[0]), rows_kv)
    return dq, grad(dst.T.copy(), qp), grad(pt.T.copy(), dop)


@functools.lru_cache(maxsize=None)
def _k9_case(name):
    """One head of a heads-major shape, drawn as chip_smoke.py draws it (q
    scaled by the head dim's -1/2 power, the wrapper's zero channels added
    after); lse and delta = rowsum(dO * O) in f32 from an f64 forward; the
    rows the model computes (dQ: the first and last 16 q rows; dK/dV: the
    first 16 kv rows, the first 16 unpadded ones and the last 16); the f64
    gradients of those rows from the same f32 inputs; and K9b's kv split at
    the chip shape's grid (132 SMs, one CTA slot an SM)."""
    d, d8, nq, nkv, causal, pads, bh = K9_SHAPES[name]
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((nq, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((nkv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((nq, d)).astype(np.float32)
    q, k, v, do = (np.pad(t, ((0, 0), (0, d8 - d))) for t in (q, k, v, do))
    bias = np.where(np.arange(nkv) < pads, np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    o, lse = f64_attention(q, k, v, bias=bias, offset=offset)
    lse = lse.astype(np.float32)
    delta = (do.astype(np.float64) * o.astype(np.float32)).sum(axis=1).astype(np.float32)
    rows_q = np.r_[0:16, nq - 16:nq]
    rows_kv = np.unique(np.r_[0:16, pads:pads + 16, nkv - 16:nkv])
    q64, k64, v64, do64 = (t.astype(np.float64) for t in (q, k, v, do))

    def p64(qi, kj):
        s = q64[qi] @ k64[kj].T + bias[kj][None].astype(np.float64)
        visible = True if offset is None else kj[None] <= qi[:, None] + offset
        return np.where(visible, np.exp(s - lse[qi][:, None].astype(np.float64)), 0.0)

    p = p64(rows_q, np.arange(nkv))
    ds = p * (do64[rows_q] @ v64.T - delta[rows_q][:, None])
    pt = p64(np.arange(nq), rows_kv).T
    dst = pt * (v64[rows_kv] @ do64.T - delta[None].astype(np.float64))
    want = {"dq": ds @ k64, "dk": dst @ q64, "dv": pt @ do64}
    nsplit = heads_dq_splits(bh, nq, nkv, d8, 132, 1)
    return (q, k, v, do, lse, delta, bias, offset), rows_q, rows_kv, want, nsplit


def _k9_errors(name, **model):
    """Largest error of the model's dQ and dK/dV rows against f64."""
    args, rows_q, rows_kv, want, nsplit = _k9_case(name)
    dq, dk, dv = k9_model(*args, rows_q, rows_kv, nsplit=nsplit, **model)
    return {"dq": float(np.abs(dq - want["dq"]).max()),
            "dkv": max(float(np.abs(dk - want["dk"]).max()), float(np.abs(dv - want["dv"]).max()))}


@pytest.mark.parametrize("name", list(K9_SHAPES))
def test_the_heads_backward_meets_a_third_of_the_tolerance(name):
    """K9a's and K9b's arithmetic (every product in f64 on the tensor cores,
    p corrected for the f32 rounding of its exponent, dS rounded once, K9b's
    split partials summed in f32) holds dK/dV within a third of the card's
    1e-5 and dQ within a third of its 6e-5 against f64, at the image
    classifier's cross-attention (all 50176 keys) and three edge cases of
    chip_smoke.py."""
    got = _k9_errors(name)
    assert got["dkv"] <= K9_DKV_TOL / 3 and got["dq"] <= K9_DQ_TOL / 3, got


@pytest.mark.parametrize("name", ["d133_causal_pad", "d512_causal", "split_walk_causal_pad"])
def test_f64_scores_beat_split_tf32_scores_in_the_heads_backward(name):
    """What the f64 score products buy: split-TF32 S and dP (four k-steps a
    fresh accumulator, rounded toward zero) leave dQ 14-21x and dK/dV 9-15x
    the error of the f64 ones at these shapes (at head dim 512 dQ reaches
    1.6e-5, a quarter of the tolerance)."""
    f64, split = _k9_errors(name), _k9_errors(name, scores="tf32")
    assert split["dq"] >= 8 * f64["dq"] and split["dkv"] >= 8 * f64["dkv"], (f64, split)


@pytest.mark.parametrize("name", ["d133_causal_pad", "d512_causal", "split_walk_causal_pad"])
def test_f64_gradients_beat_split_tf32_gradients_in_the_heads_backward(name):
    """Split-TF32 gradient products (three TF32 mmas a product, each operand
    kept to 2^-21, a fresh accumulator per walked tile rounded toward zero
    and joined by f32 adds) leave 2-5x the error of the f64 sums the kernels
    run: on the card they came out further from f64 than the plain version
    in f32 at head dims 8 and 40."""
    f64, split = _k9_errors(name), _k9_errors(name, grads="tf32")
    assert split["dq"] >= 2 * f64["dq"] and split["dkv"] >= 2 * f64["dkv"], (f64, split)


@pytest.mark.parametrize("name", ["d133_causal_pad", "d512_causal", "split_walk_causal_pad"])
def test_the_corrected_exp_cuts_the_dkv_error(name):
    """p = expf of the exponent rounded to f32 carries that rounding (up to
    2^-24 |x| absolute in x, so a relative error of p that grows with |x|);
    the kernels' one-FMA correction cuts the dK/dV error by more than 1.4x."""
    got, plain = _k9_errors(name), _k9_errors(name, exp="expf")
    assert plain["dkv"] > 1.4 * got["dkv"], (got, plain)


@pytest.mark.parametrize("d,causal,nq,nkv,n_pad", [(40, True, 70, 203, 5), (133, False, 45, 130, 10),
                                                   (320, True, 100, 100, 0)])
def test_the_heads_backward_model_agrees_with_the_jax_package(d, causal, nq, nkv, n_pad):
    """The model's dQ, dK, dV (right-aligned causal limit, the MASK_VALUE bias
    row, lengths that are no tile multiple, 32- and 16-row walks, a head dim
    the wrapper zero-pads) against the VJP of the JAX package's heads-major
    ``flash_attention``, whose Pallas backward kernels run in interpret
    mode, per head, within 1e-5 (output cotangent std 0.25, gradients up to
    ~4). Every row sees a real key."""
    from perceiver_io_tpu.ops.flash_attention import flash_attention as jax_flash

    h, d8 = 2, -(-d // 8) * 8
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((1, h, nq, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((1, h, nkv, d)).astype(np.float32) for _ in range(2))
    do = (0.25 * rng.standard_normal((1, h, nq, d))).astype(np.float32)
    pad = np.zeros((1, nkv), bool)
    pad[0, :n_pad] = True
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, pad_mask=jnp.asarray(pad), causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g)[0] for g in vjp(jnp.asarray(do))]
    bias = np.where(pad[0], np.float32(MASK_VALUE), np.float32(0))
    offset = nkv - nq if causal else None
    for hd in range(h):
        qh, kh, vh, doh = (np.pad(t[0, hd], ((0, 0), (0, d8 - d))) for t in (q, k, v, do))
        o, lse = f64_attention(qh, kh, vh, bias=bias, offset=offset)
        delta = (doh.astype(np.float64) * o).sum(axis=1).astype(np.float32)
        got = k9_model(qh, kh, vh, doh, lse.astype(np.float32), delta, bias, offset, np.arange(nq), np.arange(nkv))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g[:, :d], w[hd], atol=OUT_TOL, rtol=0, err_msg=f"{name} head {hd}")


@pytest.mark.parametrize("bh,splits", [(16, 1), (2, 4)])
def test_k9b_kv_split_at_the_main_path_shapes(bh, splits):
    """K9b at the image classifier's cross-attention (512 latents over 50176
    pixels, head dim 264; one CTA an SM): 16 x 16 q blocks of 32 rows at
    batch 16 fill 132 SMs unsplit; 2 x 16 at batch 2 split the walk 4 ways."""
    assert heads_dq_splits(bh, 512, 50176, 264, sms=132, slots=1) == splits


@pytest.mark.parametrize("bh,nq,nkv,d,slots", [(2, 512, 50176, 264, 1), (4, 130, 300, 512, 1), (4, 100, 3000, 136, 1),
                                               (3, 200, 9000, 40, 2), (1, 64, 600, 64, 2)])
def test_k9b_kv_split_never_adds_a_wave(bh, nq, nkv, d, slots):
    """A split fills the CTA slots one CTA per q block leaves idle, never
    needs a second wave, and keeps at least 8 walked tiles (32 rows up to
    head dim 288, 16 above) a split."""
    n = heads_dq_splits(bh, nq, nkv, d, 132, slots)
    rows = 32 if d <= 288 else 16
    assert n >= 1 and (n == 1 or n * bh * -(-nq // rows) <= slots * 132)
    assert n == 1 or -(-nkv // rows) >= 8 * n


def test_one_query_row_keeps_dk_dv_within_the_f32_plain_error():
    """MNIST's decoder (one query over 32 latents, one head of 128, batch
    64): with p the f64 exp of the f64 exponent, rounded to f32 once, K4a's
    dK and dV lie no further from f64 than the port's plain backward in f32
    (one product a column: dV is p dO, so p's rounding is dV's). With expf
    of the exponent rounded to f32, K4a came 3.38e-7 from f64 on an H100
    against the f32 plain version's 3.22e-7 (chip_smoke.py's
    ``mnist_dec_f32``)."""
    rng = np.random.default_rng(23)
    b, nkv, d = 64, 32, 128
    q = (rng.standard_normal((b, 1, d)) * d**-0.5).astype(np.float32)
    k, v = (rng.standard_normal((b, nkv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, 1, d)).astype(np.float32)
    bias = np.zeros(nkv, np.float32)
    model = 0.0  # the kernels' arithmetic
    outs, lses, wants = [], [], []
    for i in range(b):
        o, lse = f64_attention(q[i], k[i], v[i], bias=bias)
        lse = lse.astype(np.float32)
        delta = (do[i].astype(np.float64) * o).sum(axis=1).astype(np.float32)
        p = np.exp(q[i].astype(np.float64) @ k[i].astype(np.float64).T - lse[:, None].astype(np.float64))
        ds = p * (do[i].astype(np.float64) @ v[i].astype(np.float64).T - delta[:, None])
        want = {"dk": ds.T @ q[i].astype(np.float64), "dv": p.T @ do[i].astype(np.float64)}
        dk, dv = tf32_flash_bwd_dkv(q[i], k[i], v[i], do[i], lse, delta, np.arange(nkv), bias, None)
        model = max(model, float(np.abs(dk - want["dk"]).max()), float(np.abs(dv - want["dv"]).max()))
        outs.append(o.astype(np.float32))
        lses.append(lse)
        wants.append(want)
    got = flash_attention_packed_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, np.stack(outs))), torch.from_numpy(np.stack(lses))[..., None],
        torch.from_numpy(do), 1)
    plain = max(float(np.abs(got[g][i].numpy() - wants[i][n]).max()) for i in range(b)
                for g, n in ((1, "dk"), (2, "dv")))
    assert model <= plain, (model, plain)
