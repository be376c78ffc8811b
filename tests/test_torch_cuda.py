"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA card, at small shapes: K2 (packed flash forward), K3 (paged
decode), K1 (LayerNorm forward), K4a/K4b (packed flash backward), K5
(LayerNorm backward), K6/K7a/K7b (the two-segment flash forward and
backward), K8/K9a/K9b (the heads-major flash forward and backward), train
steps (with and without "twoseg", and of a small image classifier), the
engine serving through them, the paged decode, train and eval steps
as CUDA graphs against their eager runs, and ``Trainer.fit`` around them
(against the CPU's fit, a bit-for-bit resume, a rollback without a
recapture, the input double buffer). Marked
``cuda``; each test skips on a machine without a card. Run them on one with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
suite's conftest imports JAX, which the port does not need). Tolerances: f32
atol 1e-5 and bf16 outputs within one bf16 step, unless a test states its
own."""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (True, 37, 203, 5),     # Nq < Nkv right-aligned, left-padded keys
    (False, 64, 64, 0),
    (True, 130, 130, 0),
    (True, 100, 100, 37),   # rows 0-36 see only padded keys: their uniform average
    (True, 90, 40, 0),      # Nq > Nkv: 50 rows see no key (0, logsumexp -inf)
    (False, 70, 333, 200),  # more padding than three kv tiles
])
def test_flash_packed_kernel_matches_plain(cuda, dtype, d, causal, nq, nkv, n_pad):
    """K2 (split-TF32 products on the tensor cores in f32, bf16 products in
    bf16) against the plain version, out and logsumexp, at head dims 40, 64
    and 128 and lengths that are not multiples of the kernel's 16-row
    fragments or 64-row tiles."""
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_reference,
    )

    g = torch.Generator().manual_seed(0)
    h = 4
    q, k, v = (torch.randn(2, n, h * d, generator=g).to(cuda, dtype) for n in (nq, nkv, nkv))
    pad = torch.zeros(2, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=d**-0.5, return_lse=True)
    ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=d**-0.5)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2**-7)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,n_pad", [(True, 0), (True, 3001), (False, 0)])
def test_flash_packed_kernel_split_walk_matches_plain(cuda, d, causal, n_pad):
    """The serving prefill's kind of call (batch 1, 8 heads, 512 queries over
    4100 keys) takes K2's kv split: the walk is split across CTAs and the
    partials merged by a second pass. Out and logsumexp against the plain
    version, tolerances as above."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_reference,
        packed_kv_splits,
    )

    g = torch.Generator().manual_seed(12)
    h, nq, nkv = 8, 512, 4100
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert packed_kv_splits(1, h, nq, nkv, d, sms) > 1
    q = (torch.randn(1, nq, h * d, generator=g) * d**-0.5).to(cuda)
    k, v = (torch.randn(1, nkv, h * d, generator=g).to(cuda) for _ in range(2))
    pad = torch.zeros(1, nkv, dtype=torch.bool, device=cuda)
    pad[:, :n_pad] = True
    build.reset_launches()
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, return_lse=True)
    assert build.LAUNCHES["flash_packed_fwd"] == 1
    ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal)
    torch.testing.assert_close(o, ro, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


# name: (slots, page, pages a slot, heads, head dim, lengths)
PAGED_CASES = {
    "serve_ca": (4, 16, 1024, 8, 64, [1, 2085, 9000, 16320]),  # the flagship serve's CA pool
    "serve_sa": (4, 16, 64, 8, 64, [513, 600, 777, 1024]),  # its latent SA pools
    "edges": (5, 16, 8, 8, 64, [0, 1, 15, 16, 17]),  # lengths 0, 1, page - 1, page, page + 1
    "ca_retired": (4, 16, 1024, 8, 64, [0, 2085, 9000, 16320]),  # slot 0 retired: length 0, its row at scratch
    "skewed": (4, 16, 1024, 8, 64, [1, 1, 1, 16320]),
    "all_masked": (3, 16, 8, 8, 64, [40, 100, 128]),  # slot 0: every valid token masked
    "shared_pages": (3, 16, 8, 8, 64, [70, 128, 50]),  # slot 2 reads slot 0's first 3 pages
    "micro_odd_page": (3, 3, 6, 4, 16, [7, 18, 2]),  # pages of 3 rows, items ending mid-page
    "unaligned": (3, 8, 4, 3, 10, [5, 32, 19]),  # rows of 30 floats: 4-byte cp.async, not bulk copies
    "head_groups": (2, 4, 3, 80, 128, [9, 12]),  # one row of all heads fills no three stages
    "past_capacity": (2, 16, 4, 8, 64, [70, 9]),  # an idle slot's length past its capacity
}


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_kernel_matches_plain(cuda, case, with_mask):
    """K3 (the balanced page walk over every slot, pages copied into
    shared-memory stages, the mask read as bytes) against the plain version
    within 1e-5 at the serve's CA and SA pool geometries and edge cases,
    with and without a pad/window mask, on every slot (an all-masked slot
    and a slot of length 0 average its capacity in both); one launch
    counted a call."""
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    g = torch.Generator().manual_seed(1)
    slots, page, pps, h, d, lengths = PAGED_CASES[case]
    cache = init_paged_kv_cache(slots, 1 + slots * pps, page, pps, h * d, h * d, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    table = (torch.randperm(slots * pps, generator=g) + 1).reshape(slots, pps).to(torch.int32)
    if case == "shared_pages":
        table[2, :3] = table[0, :3]
    if case == "ca_retired":
        table[0] = 0
    cache.page_table = table.to(cuda)
    cache.length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    qh = torch.randn(slots, h, d, generator=g).to(cuda) * d**-0.5
    mask = None
    if with_mask:  # left pads / expired window slots
        mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device=cuda)
        for s, n in enumerate(lengths):
            mask[s, : min(n, cache.capacity) // 3] = True
        if case == "all_masked":
            mask[0, : lengths[0]] = True
    build.reset_launches()
    got = paged_decode_attention(qh, cache, mask)
    assert build.LAUNCHES["paged_decode"] == 1
    torch.testing.assert_close(got, paged_attention_reference(qh, cache, mask), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [8, 12, 40, 133, 264, 320, 512])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (False, 130, 300, 0),   # no tile multiple
    (True, 130, 300, 7),    # Nq < Nkv right-aligned, left-padded keys
    (True, 300, 130, 0),    # Nq > Nkv: 170 rows see no key, zero gradient
    (False, 64, 4096, 0),   # a long kv walk split across CTAs (K8, K9b)
    (True, 100, 3000, 50),  # split and causal: some splits see nothing
])
def test_flash_heads_kernels_match_plain(cuda, d, causal, nq, nkv, n_pad):
    """K8 (forward, out and logsumexp) against the plain heads-major version
    on the card, and K9a/K9b (through the autograd Function) against the
    plain backward evaluated in f64 on the same f32 inputs (the plain
    version in f32 is itself up to ~4e-5 from it at head dim 512), one
    launch each; odd widths are zero-padded by the wrapper; head dims 8 and
    320 are the edges of the kernels' buckets. Tolerance: atol 1e-5 (1e-4
    on the logsumexp), as for K2/K4."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    g = torch.Generator().manual_seed(8)
    b, h = 2, 2
    q, k, v = (torch.randn(b, h, n, d, generator=g).to(cuda).requires_grad_() for n in (nq, nkv, nkv))
    do = torch.randn(b, h, nq, d, generator=g).to(cuda)
    pad = torch.zeros(b, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    kw = dict(pad_mask=pad, causal=causal, sm_scale=d**-0.5)
    build.reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert o.grad_fn is not None and o.shape == (b, h, nq, d)
    o.backward(do)
    assert [build.LAUNCHES[n] for n in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] == [1, 1, 1]
    plain = [t.detach() for t in (q, k, v)]
    ro, rlse = flash_attention_reference(*plain, **kw)
    torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    want = flash_attention_bwd_reference(*(t.double() for t in (*plain, o.detach(), lse, do)), **kw)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), w, atol=1e-5, rtol=0)
    if causal and nq > nkv:
        assert torch.equal(q.grad[:, :, : nq - nkv], torch.zeros_like(q.grad[:, :, : nq - nkv]))


@pytest.mark.parametrize("b,nq,nkv,dqk,dv,causal", [
    (2, 130, 300, 40, 136, True),      # dqk != dv: the 256 bucket from dv
    (2, 77, 1000, 264, 72, False),     # the 288 bucket from dqk; 77 = 2 blocks of 32 + 13
    (16, 64, 4096, 264, 264, False),   # a batch-16 grid of 32 q blocks: the walk splits 4 ways
    (16, 40, 2000, 512, 320, True),    # the 512 bucket's 16-row tiles, split, causal
])
def test_flash_heads_backward_kernels_uneven_dims_and_split_grids(cuda, b, nq, nkv, dqk, dv, causal):
    """K9a and K9b where the tiling is hard: key and value widths that
    differ (the bucket follows the wider), lengths that are no multiple of
    the 32- or 16-row tiles, and batch-16 grids on which the split rule
    splits K9b's walk; against the plain backward in f64, atol 1e-5."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        _heads_dq_slots,
        flash_attention,
        flash_attention_bwd_reference,
        heads_dq_splits,
    )

    g = torch.Generator().manual_seed(12)
    h = 1
    q = (torch.randn(b, h, nq, dqk, generator=g) * dqk**-0.5).to(cuda).requires_grad_()
    k = torch.randn(b, h, nkv, dqk, generator=g).to(cuda).requires_grad_()
    v = torch.randn(b, h, nkv, dv, generator=g).to(cuda).requires_grad_()
    do = torch.randn(b, h, nq, dv, generator=g).to(cuda)
    splits = heads_dq_splits(b * h, nq, nkv, max(dqk, dv), torch.cuda.get_device_properties(cuda).multi_processor_count,
                             _heads_dq_slots(torch.cuda.current_device(), dqk, dv))
    if b == 16:
        assert splits > 1
    build.reset_launches()
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    o.backward(do)
    assert [build.LAUNCHES[n] for n in ("flash_heads_bwd_dkv", "flash_heads_bwd_dq")] == [1, 1]
    want = flash_attention_bwd_reference(*(t.detach().double() for t in (q, k, v, o, lse)), do.double(),
                                         causal=causal)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("d", [8, 64, 72, 128, 200, 256, 264, 288, 320, 512])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [(False, 130, 1000, 37), (True, 70, 2003, 0)])
def test_flash_heads_forward_kernel_every_bucket_split_and_unsplit(cuda, d, causal, nq, nkv, n_pad, nsplit):
    """K8 through its wrapper in every head-dim bucket (64, 128, 256, 288 --
    where the image CA's 264 runs, looped to 264 -- and 512, with their
    edges), unsplit and with its kv walk split 3 ways (the merge pass),
    against the plain heads-major version: out atol 1e-5, logsumexp 1e-4."""
    from perceiver_io_tpu_torch.ops import flash_attention as tflash

    g = torch.Generator().manual_seed(13)
    b, h = 2, 1
    q = (torch.randn(b, h, nq, d, generator=g) * d**-0.5).to(cuda)
    k, v = (torch.randn(b, h, nkv, d, generator=g).to(cuda) for _ in range(2))
    pad = torch.zeros(b, nkv, dtype=torch.bool, device=cuda)
    pad[0, :n_pad] = True
    bias = tflash.bias_row(pad, b, nkv, q.device)
    o, lse = tflash.heads_fwd_cuda(*tflash._heads_layout(q, k, v), h, bias, causal, 1.0, nsplit=nsplit)
    ro, rlse = tflash.flash_attention_reference(q, k, v, pad, causal)
    torch.testing.assert_close(o.reshape(ro.shape), ro, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse.reshape(rlse.shape), rlse, atol=1e-4, rtol=0)


def test_head_dim_12_runs_the_heads_major_kernel_on_the_card(cuda):
    """Head dims the packed kernel cannot take go to K8 on the card (they
    raised before the heads-major kernels were ported) and agree with the
    CPU's plain version from the same weights."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.ops import build

    torch.manual_seed(9)
    cpu = MultiHeadAttention(2, 24, 24, causal_attention=True)  # head dim 12
    card = MultiHeadAttention(2, 24, 24, causal_attention=True).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 5, 24)
    build.reset_launches()
    with torch.no_grad():
        got = card(x.to(cuda), x.to(cuda)).last_hidden_state
        want = cpu(x, x).last_hidden_state
    assert build.LAUNCHES["flash_heads_fwd"] == 1 and build.LAUNCHES["flash_packed_fwd"] == 0
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def test_classifier_shape_kernels_match_plain(cuda):
    """The image classifier's other kernels at its widths: K1 (with its
    statistics) and K5 at 1024 channels, K2 and K4a/K4b non-causal at 8
    heads of 128 over 512 x 512 (batch 2). Tolerances as in the tests
    above."""
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
        flash_attention_packed_reference,
    )
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd_reference, layer_norm_reference

    g = torch.Generator().manual_seed(10)
    x = (torch.randn(1024, 1024, generator=g) * 3 + 1).to(cuda).requires_grad_()
    w, b = (torch.randn(1024, generator=g).to(cuda).requires_grad_() for _ in range(2))
    y = layer_norm(x, w, b)
    torch.testing.assert_close(y.detach(), layer_norm_reference(x.detach(), w.detach(), b.detach()), atol=1e-5,
                               rtol=0)
    dy = torch.randn(1024, 1024, generator=g).to(cuda)
    y.backward(dy)
    xd = x.detach()
    mean = xd.mean(dim=-1)
    rstd = torch.rsqrt(torch.clamp((xd * xd).mean(dim=-1) - mean * mean, min=0.0) + 1e-5)
    dx, dw, db = layer_norm_bwd_reference(xd, w.detach(), mean, rstd, dy)
    torch.testing.assert_close(x.grad, dx, atol=4e-6, rtol=0)
    torch.testing.assert_close(w.grad, dw, atol=4e-4, rtol=0)
    torch.testing.assert_close(b.grad, db, atol=4e-4, rtol=0)

    h, d = 8, 128
    q, k, v = (torch.randn(2, 512, h * d, generator=g).to(cuda).requires_grad_() for _ in range(3))
    do = torch.randn(2, 512, h * d, generator=g).to(cuda)
    o, lse = flash_attention_packed(q, k, v, h, sm_scale=d**-0.5, return_lse=True)
    ro, rlse = flash_attention_packed_reference(q.detach(), k.detach(), v.detach(), h, sm_scale=d**-0.5)
    torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
    o.backward(do)
    want = flash_attention_packed_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(), lse, do, h,
                                                sm_scale=d**-0.5)
    for got, wnt in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, wnt, atol=1e-5, rtol=0)


def test_image_classifier_gradient_on_the_card_matches_the_cpu(cuda):
    """A small image classifier's loss gradient on the card (K8, K9a, K9b on
    the split route; K1, K2, K4, K5) against the CPU's (plain versions) from
    the same weights and batch, per parameter max abs difference <= 1e-4 of
    the largest value (the key-projection biases, whose gradient is 0 in
    exact arithmetic, within 1e-10 of 0 on both sides: measured 3.0e-13);
    then a train step runs on the card."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig
    from perceiver_io_tpu_torch.ops import build

    config = ImageClassifierConfig(
        encoder=ImageEncoderConfig(image_shape=(16, 16, 3), num_frequency_bands=32, num_cross_attention_heads=1,
                                   num_self_attention_heads=2, num_self_attention_layers_per_block=1,
                                   num_self_attention_blocks=2),
        decoder=ClassificationDecoderConfig(num_classes=4, num_output_query_channels=32,
                                            num_cross_attention_heads=1),
        num_latents=128, num_latent_channels=32,
    )
    rng = np.random.default_rng(11)
    batch = {"image": rng.normal(size=(4, 16, 16, 3)).astype(np.float32), "label": rng.integers(0, 4, size=4)}
    grads = []
    for dev in ("cpu", cuda):
        model = ImageClassifier(config, device=dev, generator=torch.Generator().manual_seed(0))
        build.reset_launches()
        loss, _ = tt.classification_loss_fn()(model, batch)
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert [build.LAUNCHES[k] for k in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] == [1, 1, 1]
    for name, want in grads[0].items():
        if name.endswith("attention.k_proj.bias"):
            assert max(float(want.abs().max()), float(grads[1][name].abs().max())) <= 1e-10, name
            continue
        assert float((grads[1][name] - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
    # the eager backward's graph (and its gradient accumulators, made on the
    # default stream) must be gone before the train step's graph is captured
    del loss, _
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3, gradient_clip=1.0))
    state, metrics = tt.make_train_step(tt.classification_loss_fn(), microbatch=2, sentinel=True)(state, batch)
    assert float(metrics["sentinel_skipped"]) == 0.0 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda, dtype):
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_reference

    g = torch.Generator().manual_seed(2)
    x = (torch.randn(1000, 512, generator=g) * 3 + 1).to(cuda, dtype)
    w, b = (torch.randn(512, generator=g).to(cuda) for _ in range(2))
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2**-7)
    torch.testing.assert_close(layer_norm(x, w, b).float(), layer_norm_reference(x, w, b).float(), **tol)


@pytest.mark.parametrize("dqk,dv", [(64, 64), (40, 40), (128, 128), (32, 32), (64, 128), (128, 40)])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (True, 37, 203, 5),    # Nq < Nkv right-aligned, left-padded keys
    (False, 64, 64, 0),
    (True, 130, 130, 0),
    (True, 90, 40, 0),     # Nq > Nkv: 50 rows see no key, zero gradient
    (True, 40, 100, 30),   # more padding than one kv tile of K4b
    (True, 77, 333, 0),    # neither length a multiple of 16
    (False, 100, 1000, 17),  # a long kv walk, every q row, left pads
    (True, 300, 173, 9),   # 127 rows see no key, the rest a ragged causal edge, left pads
    (True, 1, 70, 0),      # one query row
])
def test_flash_packed_bwd_kernels_match_plain(cuda, dqk, dv, causal, nq, nkv, n_pad):
    """K4a (dK/dV) and K4b (dQ) through the autograd Function against the
    plain backward on the card, from the same saved o/lse, at the shapes the
    tensor-core tiles make hard: lengths that are no multiple of 16 or 64,
    Dqk != Dv, the 32 / 40 / 64 / 128 head dims, left pads, and rows that
    see no key. Tolerance: atol 1e-5 on f32 gradients up to ~5 (the
    kernels' f64 score products and split-TF32 gradient products keep f32
    accuracy; the sums run in another order than the plain version's)."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
    )

    g = torch.Generator().manual_seed(3)
    h = 4
    q, k = (torch.randn(2, n, h * dqk, generator=g).to(cuda).requires_grad_() for n in (nq, nkv))
    v = torch.randn(2, nkv, h * dv, generator=g).to(cuda).requires_grad_()
    do = torch.randn(2, nq, h * dv, generator=g).to(cuda)
    pad = torch.zeros(2, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=dqk**-0.5, return_lse=True)
    assert o.grad_fn is not None
    build.reset_launches()
    o.backward(do)
    assert build.LAUNCHES["flash_packed_bwd_dkv"] == 1 and build.LAUNCHES["flash_packed_bwd_dq"] == 1
    want = flash_attention_packed_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(), lse, do, h,
                                                pad_mask=pad, causal=causal, sm_scale=dqk**-0.5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, w, atol=1e-5, rtol=0)
    if nq > nkv:
        assert torch.equal(q.grad[:, : nq - nkv], torch.zeros_like(q.grad[:, : nq - nkv]))


@pytest.mark.parametrize("rows,c", [(1000, 512), (37, 128), (15360, 512)])
def test_layer_norm_bwd_kernel_matches_plain(cuda, rows, c):
    """K1 with statistics and K5 through the autograd Function against the
    plain forward statistics and backward. Tolerances, about four times the
    measured errors: dx atol 4e-6 (measured 9.5e-7); the column sums
    dgamma/dbeta (over up to 15360 rows, values up to ~400) atol 4e-4
    (measured 9.5e-5)."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd_reference

    g = torch.Generator().manual_seed(4)
    x = (torch.randn(rows, c, generator=g) * 3 + 1).to(cuda).requires_grad_()
    w = torch.randn(c, generator=g).to(cuda).requires_grad_()
    b = torch.randn(c, generator=g).to(cuda).requires_grad_()
    dy = torch.randn(rows, c, generator=g).to(cuda)
    y = layer_norm(x, w, b)
    assert y.grad_fn is not None
    build.reset_launches()
    y.backward(dy)
    assert build.LAUNCHES["layer_norm_bwd"] == 1
    xd = x.detach()
    mean = xd.mean(dim=-1)
    rstd = torch.rsqrt(torch.clamp((xd * xd).mean(dim=-1) - mean * mean, min=0.0) + 1e-5)
    dx, dw, db = layer_norm_bwd_reference(xd, w.detach(), mean, rstd, dy)
    torch.testing.assert_close(x.grad, dx, atol=4e-6, rtol=0)
    torch.testing.assert_close(w.grad, dw, atol=4e-4, rtol=0)
    torch.testing.assert_close(b.grad, db, atol=4e-4, rtol=0)


@pytest.mark.parametrize("rows,c", [(8192, 1024), (15360, 512), (8191, 1024), (15361, 512), (999, 261), (5, 261)])
def test_layer_norm_bwd_kernel_main_path_shapes(cuda, rows, c):
    """K5 at the main path's shapes (the image classifier's 8192 x 1024
    latent rows, the CLM chunk's 15360 x 512 kv rows), at row counts one off
    them (a ragged last block and program) and at C = 261 (no power of two),
    against the plain backward from the same statistics: dx atol 2e-6,
    dgamma/dbeta 5e-4 (chip_smoke.py's tolerances); two runs give the same
    bits (the partial sums are summed in a fixed order)."""
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm_bwd_cuda, layer_norm_bwd_reference, layer_norm_cuda

    g = torch.Generator().manual_seed(14)
    x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to(cuda)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    b = (0.1 * torch.randn(c, generator=g)).to(cuda)
    dy = torch.randn(rows, c, generator=g).to(cuda)
    _, mean, rstd = layer_norm_cuda(x, w, b, 1e-5, torch.float32, want_stats=True)
    got = layer_norm_bwd_cuda(x, w, mean, rstd, dy)
    again = layer_norm_bwd_cuda(x, w, mean, rstd, dy)
    dx, dw, db = layer_norm_bwd_reference(x, w, mean, rstd, dy)
    torch.testing.assert_close(got[0], dx, atol=2e-6, rtol=0)
    torch.testing.assert_close(got[1], dw, atol=5e-4, rtol=0)
    torch.testing.assert_close(got[2], db, atol=5e-4, rtol=0)
    assert all(torch.equal(a, b2) for a, b2 in zip(got, again))


@pytest.mark.parametrize("n_pad", [0, 37], ids=["unpadded_compact", "left_padded_gather"])
def test_micro_train_step_runs_through_the_training_kernels(cuda, n_pad):
    """The gradient of a small CLM's loss on the card (K1, K2, K4a, K4b, K5)
    agrees with the CPU's (plain versions) from the same weights, keep set
    and batch, on both prefix-dropout routes (per parameter, max abs
    difference <= 1e-4 of the largest value); then a sentinel-guarded train
    step runs on the card through every training kernel (microbatched when
    the batch is unpadded: a padded one may not be split)."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build

    config = CausalLanguageModelConfig(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64,
                                       num_heads=4, num_self_attention_layers=2)
    rng = np.random.default_rng(5)
    t = rng.integers(0, 262, size=(4, 257))
    pad = None
    if n_pad:
        pad = np.zeros((4, 256), bool)
        pad[1, :n_pad] = True
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": pad,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 4, 128, 0.5)}
    grads = []
    for dev in ("cpu", cuda):
        model = CausalLanguageModel(config, device=dev, generator=torch.Generator().manual_seed(0))
        loss, _ = tt.clm_loss_fn(128)(model, batch)
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    for name, want in grads[0].items():
        assert float((grads[1][name] - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
    # the eager backward's graph (and its gradient accumulators, made on the
    # default stream) must be gone before the train step's graph is captured
    del loss, _
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3, gradient_clip=1.0))
    build.reset_launches()
    step = tt.make_train_step(tt.clm_loss_fn(128), microbatch=1 if n_pad else 2, sentinel=True)
    state, metrics = step(state, batch)
    assert float(metrics["sentinel_skipped"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    training_kernels = ("layer_norm_fwd", "flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq",
                        "layer_norm_bwd")
    assert all(build.LAUNCHES[k] > 0 for k in training_kernels), build.LAUNCHES


def test_engine_serves_through_the_kernels(cuda):
    from perceiver_io_tpu_torch.generation import GenerationConfig, make_decode_fns
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config = CausalLanguageModelConfig(vocab_size=64, max_seq_len=64, max_latents=16, num_channels=64,
                                       num_heads=4, num_self_attention_layers=2)
    model = CausalLanguageModel(config, device=cuda, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    specs = [RequestSpec(i, n, 6, rng.integers(0, 64, size=(1, n)), i) for i, n in enumerate([20, 33, 41])]
    engine = EngineFrontEnd(model, num_latents=8, device=cuda,
                            engine_config=EngineConfig(slots=2, page_size=16, max_ca_tokens=48, max_sa_tokens=16))
    build.reset_launches()
    engine.run_closed(specs, concurrency=3)
    serving_kernels = ("flash_packed_fwd", "paged_decode", "layer_norm_fwd")
    assert all(build.LAUNCHES[k] > 0 for k in serving_kernels), build.LAUNCHES
    assert build.LAUNCHES["layer_norm_bwd"] == build.LAUNCHES["flash_packed_bwd_dq"] == 0
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0
    for spec in specs:
        prefill, step = make_decode_fns(model, 8, GenerationConfig(max_new_tokens=6), device=cuda)
        token, state = prefill(spec.input_ids)
        want = [int(token[0])]
        for _ in range(5):
            state, token = step(state)
            want.append(int(token[0]))
        assert engine.served_tokens[spec.index] == want


def test_engine_serves_head_dim_160_by_the_gather_route(cuda):
    """Heads of 160 (320 channels in 2 heads), which K3 took only through the
    gather route before it served heads up to 512: the engine's decode now
    launches K3 at every step (the gather route is its plain version), the
    prefill runs the heads-major K8, and the served stream equals the
    sequential one on the card."""
    from perceiver_io_tpu_torch.generation import GenerationConfig, make_decode_fns
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config = CausalLanguageModelConfig(vocab_size=64, max_seq_len=24, max_latents=8, num_channels=320,
                                       num_heads=2, num_self_attention_layers=2)
    model = CausalLanguageModel(config, device=cuda, generator=torch.Generator().manual_seed(0))
    ids = np.random.default_rng(1).integers(0, 64, size=(1, 8))
    engine = EngineFrontEnd(model, num_latents=4, device=cuda,
                            engine_config=EngineConfig(slots=2, page_size=8, max_ca_tokens=24, max_sa_tokens=16))
    build.reset_launches()
    records = engine.run_closed([RequestSpec(0, 8, 4, ids, 0)], concurrency=1)
    assert [r.outcome for r in records] == ["ok"]
    assert build.LAUNCHES["paged_decode"] > 0 and build.LAUNCHES["flash_heads_fwd"] > 0, build.LAUNCHES
    prefill, step = make_decode_fns(model, 4, GenerationConfig(max_new_tokens=4), device=cuda)
    token, state = prefill(ids)
    want = [int(token[0])]
    for _ in range(3):
        state, token = step(state)
        want.append(int(token[0]))
    assert engine.served_tokens[0] == want


@pytest.mark.parametrize("heads,d,dtype", [(2, 192, torch.float32), (2, 192, torch.bfloat16),
                                           (2, 640, torch.float32), (2, 640, torch.bfloat16)])
def test_paged_decode_refuses_what_only_the_jax_kernel_serves(cuda, heads, d, dtype):
    """Pools that the JAX package's paged kernel serves: K3 takes heads of
    192 (f32 and bf16 pools) since it serves heads up to 512, one launch a
    call, its output the plain version's projected (f32 within 1e-5, bf16
    within 2e-2 of the largest magnitude); heads of 640 still raise before
    anything launches, with K3's limit in the message (the gather route
    stands in only where the JAX package gathers too)."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference

    c = heads * d
    g = torch.Generator().manual_seed(3)
    layer = MultiHeadAttention(heads, c, c, causal_attention=True, dtype=dtype).to(cuda)
    cache = init_paged_kv_cache(2, 5, 8, 2, c, c, dtype=dtype, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    cache.page_table.copy_(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    cache.length[:] = 3
    x = torch.randn(2, 1, c, generator=g).to(cuda, dtype)
    build.reset_launches()
    if d > 512:
        with torch.no_grad(), pytest.raises(ValueError, match="K3 does not.*up to 512"):
            layer(x, x, kv_cache=cache)
        assert build.LAUNCHES["paged_decode"] + build.LAUNCHES["paged_decode_bf16"] == 0
        return
    with torch.no_grad():
        out = layer(x, x, kv_cache=cache)
        qh = layer.project_q(x)[:, :, 0, :]
        want = layer._proj(layer.o_proj, paged_attention_reference(qh, out.kv_cache).reshape(2, 1, c))
    name = "paged_decode" if dtype == torch.float32 else "paged_decode_bf16"
    assert build.LAUNCHES[name] == 1, build.LAUNCHES
    got, want = out.last_hidden_state.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


# name: (slots, page, pages a slot, heads, head dim, lengths); heads wider than 128
WIDE_PAGED_CASES = {
    "h2_d192": (4, 16, 64, 2, 192, [0, 1, 517, 1024]),  # the serve CA's page, a length-0 slot
    "h2_d256": (4, 16, 64, 2, 256, [17, 0, 300, 1023]),
    "h1_d512": (3, 16, 64, 1, 512, [1000, 0, 16]),
    "odd_page": (3, 3, 8, 3, 160, [7, 0, 24]),  # pages of 3 rows, items ending mid-page
    "unaligned": (2, 8, 4, 2, 130, [5, 0]),  # rows of 260 f32 (520 bytes): no bulk copies
    "head_groups": (2, 16, 4, 16, 512, [33, 64]),  # 16 heads of 512: two groups of 8, a row a stage
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(WIDE_PAGED_CASES))
def test_paged_decode_wide_heads_match_plain(cuda, dtype, case, with_mask):
    """K3 at head dims over 128 (16 or 8 channels a lane, one head a consumer
    warp), f32 and bf16 builds, against the plain version on every slot,
    with and without a pad mask, a length-0 slot in most cases: f32 within
    1e-5; bf16 by the card's bf16 rule against the f64 evaluation (as the
    narrow bf16 cases) and within 1e-2 of the largest magnitude. One launch
    a call."""
    from perceiver_io_tpu_torch.core.cache import PagedKVCache, init_paged_kv_cache
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    g = torch.Generator().manual_seed(2)
    slots, page, pps, h, d, lengths = WIDE_PAGED_CASES[case]
    cache = init_paged_kv_cache(slots, 1 + slots * pps, page, pps, h * d, h * d, dtype=dtype, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    table = (torch.randperm(slots * pps, generator=g) + 1).reshape(slots, pps).to(torch.int32)
    table[[i for i, n in enumerate(lengths) if n == 0]] = 0  # a retired slot's row is all scratch
    cache.page_table = table.to(cuda)
    cache.length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    qh = (torch.randn(slots, h, d, generator=g) * d**-0.5).to(cuda, dtype)
    mask = None
    if with_mask:
        mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device=cuda)
        for s, n in enumerate(lengths):
            mask[s, : min(n, cache.capacity) // 3] = True
    build.reset_launches()
    got = paged_decode_attention(qh, cache, mask)
    name = "paged_decode" if dtype == torch.float32 else "paged_decode_bf16"
    assert build.LAUNCHES[name] == 1, build.LAUNCHES
    plain = paged_attention_reference(qh, cache, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
        return
    c64 = PagedKVCache(cache.k.double(), cache.v.double(), cache.page_table, cache.length)
    _bf16_rule(got, plain, paged_attention_reference(qh.double(), c64, mask), 1.0, slack=1e-6)
    assert float((got.float() - plain.float()).abs().max()) <= 1e-2 * float(plain.float().abs().max())


@pytest.mark.parametrize("d", [64, 40, 128, 32])
@pytest.mark.parametrize("n_p,nq,n_pad", [
    (1, 100, 0),      # the minimum prefix; Nq no tile multiple
    (70, 130, 5),     # the seam inside a tile; left-padded prefix keys
    (200, 128, 0),
    (129, 37, 100),   # a prefix of one tile and one row, mostly padded
])
def test_flash_2seg_kernels_match_plain(cuda, d, n_p, nq, n_pad):
    """K6 (forward, out and logsumexp) against the plain two-segment
    version, and K7a/K7b (through the autograd Function; f64 score products
    and dQ, split-TF32 dK/dV on K4's tensor-core tiles) against the plain
    backward evaluated in f64 on the same f32 inputs, with one launch each.
    Tolerance: atol 1e-5 (1e-4 on the logsumexp), as for K2/K4; and each
    kernel no further from the f64 evaluation than the plain backward
    evaluated in f32 is (the tensor-core sums do not run in its order, so it
    cannot be the reference itself): K7a's dK/dV of both segments against
    the f32 plain dK/dV, K7b's dQ against the f32 plain dQ."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed_2seg,
        flash_attention_packed_2seg_bwd_reference,
        flash_attention_packed_2seg_reference,
    )

    g = torch.Generator().manual_seed(6)
    h = 4
    q, k_l, v_l = (torch.randn(2, nq, h * d, generator=g).to(cuda).requires_grad_() for _ in range(3))
    k_p, v_p = (torch.randn(2, n_p, h * d, generator=g).to(cuda).requires_grad_() for _ in range(2))
    do = torch.randn(2, nq, h * d, generator=g).to(cuda)
    pad_p = torch.zeros(2, n_p, dtype=torch.bool, device=cuda)
    pad_p[1, :n_pad] = True
    pad_l = torch.zeros(2, nq, dtype=torch.bool, device=cuda)
    ops = (q, k_p, v_p, k_l, v_l)
    kw = dict(pad_mask_prefix=pad_p, pad_mask_latent=pad_l, sm_scale=d**-0.5)
    build.reset_launches()
    o, lse = flash_attention_packed_2seg(*ops, h, return_lse=True, **kw)
    assert o.grad_fn is not None
    o.backward(do)
    assert [build.LAUNCHES[k] for k in ("flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq")] == [1, 1, 1]
    assert build.LAUNCHES["flash_packed_fwd"] == build.LAUNCHES["flash_packed_bwd_dq"] == 0
    plain = [t.detach() for t in ops]
    ro, rlse = flash_attention_packed_2seg_reference(*plain, h, **kw)
    torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    want = flash_attention_packed_2seg_bwd_reference(*(t.double() for t in (*plain, o.detach(), lse, do)), h, **kw)
    f32 = flash_attention_packed_2seg_bwd_reference(*plain, o.detach(), lse, do, h, **kw)
    got = [t.grad for t in ops]
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x.double(), w, atol=1e-5, rtol=0)

    def dist(xs, ws):
        return max(float((x.double() - w).abs().max()) for x, w in zip(xs, ws))

    for kernel, grads in (("K7b dQ", slice(0, 1)), ("K7a dK/dV", slice(1, 5))):
        mine, plain = dist(got[grads], want[grads]), dist(f32[grads], want[grads])
        assert mine <= plain, (kernel, mine, plain)


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("b,h,n_p,nq,n_pad,split", [
    (2, 4, 1000, 130, 0, False),  # a walk of 16 prefix tiles, the seam inside a tile
    (2, 4, 777, 70, 700, False),  # the first latents' visible keys mostly padded
    (2, 4, 3, 200, 3, False),     # every prefix key padded: row i averages latents 0..i
    (1, 8, 5000, 130, 0, True),   # 24 q blocks for 264 CTA slots: the walk split, partials merged
    (1, 8, 5000, 130, 4500, True),
])
def test_flash_2seg_forward_long_walk_matches_plain(cuda, d, b, h, n_p, nq, n_pad, split):
    """K6 (split-TF32 products on the tensor cores, K2's tiles) over walks
    longer than its double buffer, split across CTAs where the grid is
    small; out and logsumexp against the plain two-segment version,
    tolerances as for K2."""
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed_2seg,
        flash_attention_packed_2seg_reference,
        packed_kv_splits,
    )

    g = torch.Generator().manual_seed(13)
    if split:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert packed_kv_splits(b, h, nq, n_p + nq, d, sms) > 1
    q = (torch.randn(b, nq, h * d, generator=g) * d**-0.5).to(cuda)
    k_l, v_l = (torch.randn(b, nq, h * d, generator=g).to(cuda) for _ in range(2))
    k_p, v_p = (torch.randn(b, n_p, h * d, generator=g).to(cuda) for _ in range(2))
    pad_p = torch.zeros(b, n_p, dtype=torch.bool, device=cuda)
    pad_p[-1, :n_pad] = True
    ops = (q, k_p, v_p, k_l, v_l)
    o, lse = flash_attention_packed_2seg(*ops, h, pad_mask_prefix=pad_p, return_lse=True)
    ro, rlse = flash_attention_packed_2seg_reference(*ops, h, pad_mask_prefix=pad_p)
    torch.testing.assert_close(o, ro, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


def test_flash_2seg_takes_f32_only(cuda):
    """K6/K7 take f32 and (since their bf16 builds) bf16 operands of one
    dtype, nothing else: f16 operands and mixed dtypes raise."""
    from perceiver_io_tpu_torch.ops.flash_attention import flash_attention_packed_2seg

    q, k, v = (torch.randn(1, 64, 128, device=cuda, dtype=torch.float16) for _ in range(3))
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        flash_attention_packed_2seg(q, k, v, k, v, 2)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_packed_2seg(q.float(), k.bfloat16(), v.bfloat16(), k.bfloat16(), v.bfloat16(), 2)


@pytest.mark.parametrize("n_pad", [0, 37], ids=["unpadded_compact", "left_padded_gather"])
def test_micro_train_step_under_twoseg_runs_through_the_2seg_kernels(cuda, n_pad):
    """Under ``fast_kernels({"twoseg"})`` a small CLM's loss gradient on the
    card (K6, K7a, K7b for the cross-attention) agrees with the CPU's (plain
    versions) from the same weights, keep set and batch (per parameter, max
    abs difference <= 1e-4 of the largest value), on both prefix-dropout
    routes; the backward runs after the scope has closed."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    config = CausalLanguageModelConfig(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64,
                                       num_heads=4, num_self_attention_layers=2)
    rng = np.random.default_rng(7)
    t = rng.integers(0, 262, size=(2, 257))
    pad = None
    if n_pad:
        pad = np.zeros((2, 256), bool)
        pad[1, :n_pad] = True
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": pad,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 128, 0.5)}
    grads = []
    for dev in ("cpu", cuda):
        model = CausalLanguageModel(config, device=dev, generator=torch.Generator().manual_seed(0))
        build.reset_launches()
        with fast_kernels({"twoseg"}):
            loss, _ = tt.clm_loss_fn(128)(model, batch)
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert [build.LAUNCHES[k] for k in ("flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq")] == [1, 1, 1]
    assert build.LAUNCHES["flash_packed_fwd"] == 2  # the two SA layers only
    for name, want in grads[0].items():
        assert float((grads[1][name] - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


def test_token_lookup_gradient_repeats_bit_for_bit(cuda):
    """The port's table lookup (``core/adapter.py::lookup``) at a flagship
    chunk's 17408 token ids over 262 rows: the weight gradient repeats bit
    for bit over five calls (``F.embedding``'s CUDA backward gave eight
    different results in eight calls at this shape) and agrees with
    ``F.embedding``'s within f32 rounding (atol 1e-4 on sums of ~66 rows of
    unit scale)."""
    from perceiver_io_tpu_torch.core.adapter import lookup

    g = torch.Generator().manual_seed(0)
    table = torch.nn.Embedding(262, 512).to(cuda)
    ids = torch.randint(0, 262, (2, 8704), generator=g).to(cuda)
    dy = torch.randn(2, 8704, 512, generator=g).to(cuda)
    grads = []
    for _ in range(5):
        table.weight.grad = None
        lookup(table, ids).backward(dy)
        grads.append(table.weight.grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    table.weight.grad = None
    torch.nn.functional.embedding(ids, table.weight).backward(dy)
    torch.testing.assert_close(grads[0], table.weight.grad, atol=1e-4, rtol=0)


_GRAD_PROCESS = """
import hashlib, sys
import numpy as np, torch
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels
torch.backends.cuda.matmul.allow_tf32 = False
config = CausalLanguageModelConfig(vocab_size=262, max_seq_len=4096, max_latents=512, num_channels=64,
                                   num_heads=4, num_self_attention_layers=1)
rng = np.random.default_rng(5)
t = rng.integers(0, 262, size=(2, 4097))
batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
         "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 4096 - 512, 0.5)}
model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(0))
with fast_kernels(frozenset(sys.argv[1:])):
    loss, _ = tt.clm_loss_fn(512)(model, batch)
loss.backward()
h = hashlib.sha256()
for name, p in model.named_parameters():
    h.update(name.encode() + p.grad.detach().cpu().numpy().tobytes())
print(h.hexdigest())
"""


@pytest.mark.parametrize("route", [(), ("twoseg",)], ids=["concat", "twoseg"])
def test_clm_train_step_gradient_is_bitwise_equal_in_two_processes(cuda, route):
    """A small CLM's train-step gradient (4096 tokens, 512 latents, batch 2:
    4608 token ids a step, past the 3072 at which ``F.embedding``'s CUDA
    backward starts to sum in an order that moves) computed in two fresh
    processes: every parameter's gradient bit for bit the same."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    digests = [subprocess.run([sys.executable, "-c", _GRAD_PROCESS, *route], cwd=root, env=env, check=True,
                              capture_output=True, text=True).stdout.strip() for _ in range(2)]
    assert digests[0] and digests[0] == digests[1], digests


# ---------------------------------------------------------------------------
# the steps as CUDA graphs
# ---------------------------------------------------------------------------

_GRAPH_CLM = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
                  num_self_attention_layers=2)


def _eager_paged_step(model, config):
    """The paged step's eager reference: the host's draws, then the body."""
    from perceiver_io_tpu_torch import generation

    stage = generation._UniformStage(config, model.device)

    def step(state):
        stage(state)
        return generation._paged_decode_step_body(model, config, state)

    return step


def test_graphed_paged_step_equals_the_eager_body_with_joins_and_retires(cuda):
    """Two engines over one small CLM on the card, one replaying the captured
    paged step and one running its body eagerly, serve the same ragged,
    sampled (temperature, top-k, top-p) requests through 3 slots: at least
    64 decode steps with joins and retires between replays, every stream
    equal token for token, and the books and page allocators clean."""
    from perceiver_io_tpu_torch.generation import GenerationConfig
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config = CausalLanguageModelConfig(**dict(_GRAPH_CLM, max_seq_len=64, max_latents=16))
    model = CausalLanguageModel(config, device=cuda, generator=torch.Generator().manual_seed(0))
    gen_config = GenerationConfig(do_sample=True, temperature=0.8, top_k=40, top_p=0.9)
    rng = np.random.default_rng(3)
    specs = []
    for i in range(20):
        n = int(rng.integers(20, 44))
        specs.append(RequestSpec(i, n, int(rng.integers(8, 20)), rng.integers(0, 262, size=(1, n)),
                                 int(rng.integers(1 << 20))))
    streams, steps = [], []
    for graphed in (True, False):
        engine = EngineFrontEnd(model, num_latents=8, base_config=gen_config, device=cuda,
                                engine_config=EngineConfig(slots=3, page_size=16, max_ca_tokens=64,
                                                           max_sa_tokens=32))
        if not graphed:
            engine._step_fn = _eager_paged_step(model, gen_config)
        records = engine.run_closed(specs, concurrency=5)
        assert [r.outcome for r in records] == ["ok"] * len(specs)
        assert engine.books()["balanced"] and engine.ca_alloc.pages_used == engine.sa_alloc.pages_used == 0
        streams.append(dict(engine.served_tokens))
        steps.append(engine._engine_steps)
    assert steps[0] == steps[1] >= 64
    assert streams[0] == streams[1]


def test_int8_engine_graph_equals_the_eager_step(cuda):
    """The engine on int8 pools and int8 weights (a bf16 model): the
    captured paged step (the gather route, the weights dequantized inside
    the graph at every replay) against its eager body (the same weights'
    buffers) on the same sampled, ragged requests: every stream equal token
    for token over 40+ decode steps with joins and retires; K3 never
    launches over int8 pools; the step captures once."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config = CausalLanguageModelConfig(**dict(_GRAPH_CLM, max_seq_len=64, max_latents=16))
    model = CausalLanguageModel(config, device=cuda, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    gen_config = generation.GenerationConfig(do_sample=True, temperature=0.8, top_k=40)
    rng = np.random.default_rng(5)
    specs = [RequestSpec(i, n, int(rng.integers(8, 16)), rng.integers(0, 262, size=(1, n)), i)
             for i, n in enumerate(int(x) for x in rng.integers(20, 44, size=12))]
    streams, steps = [], []
    for graphed in (True, False):
        engine = EngineFrontEnd(model, num_latents=8, base_config=gen_config, cache_dtype=torch.int8,
                                weight_dtype=torch.int8, device=cuda,
                                engine_config=EngineConfig(slots=3, page_size=16, max_ca_tokens=64,
                                                           max_sa_tokens=32))
        captured = engine._step_fn.captured
        if not graphed:
            engine._step_fn = generation._eager_step(model, gen_config, model.device, captured.body)
        build.reset_launches()
        records = engine.run_closed(specs, concurrency=5)
        assert [r.outcome for r in records] == ["ok"] * len(specs)
        assert build.LAUNCHES["paged_decode"] == build.LAUNCHES["paged_decode_bf16"] == 0
        assert captured.captures == 1
        streams.append(dict(engine.served_tokens))
        steps.append(engine._engine_steps)
    assert steps[0] == steps[1] >= 40
    assert streams[0] == streams[1]


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_int8_weights_decode_pair_graph_equals_eager_bit_for_bit(cuda, cache_dtype):
    """``make_decode_fns`` on int8 weights (and a bf16 or int8 cache) in a
    bf16 model: the captured step and its eager body (the same weights'
    buffers, ``step.body.body``) from the same prefill give the same stream
    and every step's logits bit for bit over 20 steps that slide both
    windows; the parameters are as they were after both."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**_DECODE_CLM), device=cuda, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    before = {n: p.clone() for n, p in model.named_parameters()}
    config = generation.GenerationConfig(max_new_tokens=21)
    ids = np.random.default_rng(4).integers(0, 262, size=(2, 64))
    prefill, step = generation.make_decode_fns(model, 16, config, cache_dtype, torch.int8, device=cuda)
    eager = generation._eager_step(model, config, cuda, step.body.body)
    streams, logits = {}, {}
    for name, body in (("graph", step), ("eager", eager)):
        token, state = prefill(ids)
        streams[name], logits[name] = [token.clone()], []
        for _ in range(20):
            state, token = body(state)
            streams[name].append(token.clone())
            logits[name].append(state["logits"].clone())
    assert isinstance(step.body, generation._GraphedStep) and step.body.captures == 1
    assert all(torch.equal(a, b) for a, b in zip(streams["graph"], streams["eager"]))
    assert all(torch.equal(a, b) and torch.isfinite(a).all() for a, b in zip(logits["graph"], logits["eager"]))
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_graph_replays_count_their_launches(cuda):
    """A replay adds the launches its capture recorded: after N replays of
    the captured paged step, ``LAUNCHES`` holds N times the capture's count,
    which is K3 once per pool (the CA and each SA layer) a step."""
    from perceiver_io_tpu_torch.generation import GenerationConfig
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd

    config = CausalLanguageModelConfig(**dict(_GRAPH_CLM, max_seq_len=64, max_latents=16))
    model = CausalLanguageModel(config, device=cuda, generator=torch.Generator().manual_seed(0))
    engine = EngineFrontEnd(model, num_latents=8, base_config=GenerationConfig(), device=cuda,
                            engine_config=EngineConfig(slots=2, page_size=16, max_ca_tokens=64, max_sa_tokens=32))
    graph = engine._step_fn.captured.graph
    assert graph.launches["paged_decode"] == 1 + config.num_self_attention_layers
    build.reset_launches()
    for _ in range(7):
        engine._step_fn(engine._state)
    torch.cuda.synchronize()
    assert {k: n for k, n in build.LAUNCHES.items() if n} == {k: 7 * n for k, n in graph.launches.items()}
    nodes = graph.kernel_nodes(["paged_walk_kernel", "paged_merge_kernel"])
    assert nodes["paged_walk_kernel"] == nodes["paged_merge_kernel"] == graph.launches["paged_decode"], nodes


def _graph_train_run(cuda, route, jit, batches, sentinel=False, poison=None, microbatch=2, dtype=torch.float32,
                     moment_dtype=None, options=None, optim=None, lr=None):
    """A small CLM's train steps on ``batches`` (clip 1.0, a warmup-cosine
    schedule), a CUDA graph with ``jit``; the loss multiplied
    by each step's ``poison`` value where given; the model's compute dtype
    and the moments' storage dtype as given; ``options`` the config's
    training options (dropout drawn from a CUDA generator seeded 5),
    ``optim`` more ``make_optimizer`` arguments, ``lr`` a constant rate.
    Returns the state, each step's metrics and each step's optimizer state
    tensors."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM, **(options or {})), device=cuda,
                                generator=torch.Generator().manual_seed(0), dtype=dtype)
    schedule = tt.cosine_with_warmup(1e-3, 6, 1) if lr is None else lr
    state = tt.TrainState.create(model, tt.make_optimizer(schedule, gradient_clip=1.0, moment_dtype=moment_dtype,
                                                          **(optim or {})),
                                 generator=torch.Generator(device=cuda).manual_seed(5))
    loss_fn = tt.clm_loss_fn(128)
    if poison is not None:
        base = loss_fn

        def loss_fn(model, batch, generator=None):
            loss, _ = base(model, batch, generator)
            loss = loss * batch["poison"]
            return loss, {"loss": loss}

    step = tt.make_train_step(loss_fn, microbatch=microbatch, sentinel=sentinel, jit=jit)
    metrics, tensors = [], []
    with fast_kernels(set(route)):
        for i, batch in enumerate(batches):
            if poison is not None:
                batch = dict(batch, poison=np.float32(poison[i]))
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            tensors.append([t.clone() for t in state.optimizer.state_tensors()])
    return state, metrics, tensors


def _graph_batches(n, seed=9):
    from perceiver_io_tpu_torch import training as tt

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, 262, size=(4, 257))
        out.append({"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
                    "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 4, 128, 0.5)})
    return out


def _assert_close_relative(got, want, rtol):
    for g, w in zip(got, want):
        assert float((g.double() - w.double()).abs().max()) <= rtol * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("route", [(), ("twoseg",)], ids=["concat", "twoseg"])
def test_graphed_train_step_equals_the_eager_step(cuda, route):
    """Three CLM train steps (microbatch 2, clip, a warmup-cosine schedule,
    fresh keep sets) as a CUDA graph and eagerly, from the same weights:
    the losses, and the parameters, AdamW moments and steps and the count
    after the third, agree within 1e-6 relative to each tensor's largest
    value (the same kernels on the same inputs; cuBLAS may pick other
    algorithms under capture)."""
    batches = _graph_batches(3)
    graphed, g_metrics, g_tensors = _graph_train_run(cuda, route, True, batches)
    eager, e_metrics, e_tensors = _graph_train_run(cuda, route, False, batches)
    np.testing.assert_allclose([m["loss"] for m in g_metrics], [m["loss"] for m in e_metrics], rtol=1e-6)
    _assert_close_relative(g_tensors[-1], e_tensors[-1], 1e-6)
    assert graphed.step == eager.step == 3 and int(graphed.optimizer.count) == 3


def test_graphed_train_step_skips_a_poisoned_batch(cuda):
    """Under the graph a NaN loss (the batch's ``poison`` buffer, step 2, a
    replay) is skipped on the device: parameters, moments, AdamW's steps and
    the count hold bit for bit, ``sentinel_skipped`` is 1; the next finite
    step matches the eager run (within 1e-6 relative)."""
    batches, poison = _graph_batches(3, seed=10), [1.0, np.nan, 1.0]
    run = dict(sentinel=True, poison=poison, microbatch=1)  # a 0-d poison value splits into no chunks
    graphed, g_metrics, g_tensors = _graph_train_run(cuda, (), True, batches, **run)
    eager, e_metrics, e_tensors = _graph_train_run(cuda, (), False, batches, **run)
    assert [m["sentinel_skipped"] for m in g_metrics] == [m["sentinel_skipped"] for m in e_metrics] == [0.0, 1.0, 0.0]
    assert all(torch.equal(a, b) for a, b in zip(g_tensors[1], g_tensors[0]))
    assert int(graphed.optimizer.count) == 2 and graphed.step == 3
    np.testing.assert_allclose(g_metrics[2]["loss"], e_metrics[2]["loss"], rtol=1e-6)
    _assert_close_relative(g_tensors[2], e_tensors[2], 1e-6)


def test_graphed_train_step_redraws_a_cuda_generators_keep_set(cuda):
    """A batch without a keep set makes the forward draw one on the card from
    ``state.generator``: the graph registers that generator, so replays on
    the same batch and weights (lr 0) draw other keep sets and give other
    losses, as the eager steps do."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    batch = dict(_graph_batches(1, seed=11)[0])
    del batch["prefix_keep_idx"]
    losses = {}
    for jit in (True, False):
        model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM), device=cuda,
                                    generator=torch.Generator().manual_seed(0))
        gen = torch.Generator(device=cuda).manual_seed(5)
        before = [p.detach().clone() for p in model.parameters()]
        state = tt.TrainState.create(model, tt.make_optimizer(0.0), generator=gen)
        step = tt.make_train_step(tt.clm_loss_fn(128), jit=jit)
        losses[jit] = [float(step(state, batch)[1]["loss"]) for _ in range(4)]
        assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))
    for run in losses.values():
        assert np.isfinite(run).all() and len(set(run)) == 4, losses


def test_graphed_eval_step_equals_the_eager_forward(cuda):
    """``make_eval_step`` on the card (a CUDA graph) gives the eager
    forward's logits within 1e-6 relative, for two batches through one
    capture, and captures anew for another batch shape."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM), device=cuda,
                                generator=torch.Generator().manual_seed(0))

    def eval_fn(model, batch):
        return model(torch.as_tensor(batch["input_ids"], device=cuda), prefix_len=128).logits

    step = tt.make_eval_step(eval_fn)
    rng = np.random.default_rng(12)
    for shape in ((2, 256), (2, 256), (3, 200)):
        batch = {"input_ids": rng.integers(0, 262, size=shape)}
        got = step(model, batch)
        with torch.no_grad():
            want = eval_fn(model, batch)
        _assert_close_relative([got], [want], 1e-6)


def test_capturable_adamw_on_the_card_matches_the_cpus_optimizer(cuda):
    """Three updates (clip 1.0, a warmup-cosine schedule on the count
    tensor, so the first at a rate of 0) from the same gradients, one row of
    which is always 0 (its second moment stays 0): AdamW with
    ``capturable=True`` on the card against the CPU's fused AdamW, which
    tests/test_torch_graph_train.py holds to optax; within 1e-6 on
    parameters of order 1 (f32, the two evaluate the bias corrections in
    other orders)."""
    from perceiver_io_tpu_torch import training as tt

    rng = np.random.default_rng(14)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((64, 32), (32,))]
    params = {dev: [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev)) for a in p0] for dev in ("cpu", cuda)}
    opts = {dev: tt.make_optimizer(tt.cosine_with_warmup(5e-2, 4, 1), weight_decay=0.05, gradient_clip=1.0)(ps)
            for dev, ps in params.items()}
    assert opts[cuda].adamw.param_groups[0]["capturable"]
    for _ in range(3):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in p0]
        grads[0][0] = 0.0
        for dev, ps in params.items():
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g).to(dev)
            opts[dev].step()
    for got, want in zip(params[cuda], params["cpu"]):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-6, rtol=0)
    assert int(opts[cuda].count) == 3


def test_a_schedule_that_cannot_take_a_tensor_refuses_the_capture(cuda):
    """A schedule that branches on the host cannot run inside the graph: the
    captured step raises and says so (the eager step still runs it)."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    def host_schedule(step):
        return 1e-3 if step < 10 else 1e-4

    batch = _graph_batches(1, seed=13)[0]
    model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM), device=cuda,
                                generator=torch.Generator().manual_seed(0))
    state = tt.TrainState.create(model, tt.make_optimizer(host_schedule))
    tt.make_train_step(tt.clm_loss_fn(128), jit=False)(state, batch)
    with pytest.raises(RuntimeError, match="schedule"):
        tt.make_train_step(tt.clm_loss_fn(128))(state, batch)



# ---------------------------------------------------------------------------
# bf16: the CLM's bf16 builds (K4a/K4b, K3) and its bf16 train step
# ---------------------------------------------------------------------------


def _l2(a, b) -> float:
    return float((a.double() - b.double()).norm())


def _bf16_rule(kernel, plain, f64, margin: float, slack: float = 0.0):
    """The card's bf16 rule: the kernel no further from the f64 evaluation
    of the same bf16 inputs than ``margin`` x the bf16 plain version (L2),
    plus ``slack`` x |f64| (L2); and within 2e-2 of the plain version's
    largest magnitude, element by element."""
    assert torch.isfinite(kernel.float()).all()
    assert _l2(kernel, f64) <= margin * _l2(plain, f64) + slack * float(f64.double().norm())
    assert float((kernel.float() - plain.float()).abs().max()) <= 2e-2 * float(plain.float().abs().max())


@pytest.mark.parametrize("dqk,dv", [(64, 64), (40, 40), (128, 128), (32, 32), (64, 128)])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (True, 37, 203, 5),    # Nq < Nkv right-aligned, left-padded keys
    (False, 64, 64, 0),
    (True, 130, 130, 0),
    (True, 90, 40, 0),     # Nq > Nkv: 50 rows see no key, zero gradient
    (True, 77, 333, 0),    # neither length a multiple of 16
    (False, 100, 1000, 17),  # a long kv walk, left pads
])
def test_flash_packed_bwd_bf16_kernels_match_plain(cuda, dqk, dv, causal, nq, nkv, n_pad):
    """K4a/K4b's bf16 build (bf16 mma.sync, p and dS rounded to bf16 before
    the gradient products) through the autograd Function: each gradient is
    no further from the plain backward evaluated in f64 on the same bf16
    inputs than 1.25x the bf16 plain version (L2), and within 2e-2 of the
    plain version's largest magnitude; one bf16 launch each, no f32 one."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
    )

    g = torch.Generator().manual_seed(3)
    h = 4
    q, k = (torch.randn(2, n, h * dqk, generator=g).to(cuda, torch.bfloat16).requires_grad_() for n in (nq, nkv))
    v = torch.randn(2, nkv, h * dv, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    do = torch.randn(2, nq, h * dv, generator=g).to(cuda, torch.bfloat16)
    pad = torch.zeros(2, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=dqk**-0.5, return_lse=True)
    build.reset_launches()
    o.backward(do)
    assert (build.LAUNCHES["flash_packed_bwd_dkv_bf16"], build.LAUNCHES["flash_packed_bwd_dq_bf16"]) == (1, 1)
    assert build.LAUNCHES["flash_packed_bwd_dkv"] == build.LAUNCHES["flash_packed_bwd_dq"] == 0
    ops = [t.detach() for t in (q, k, v, o)]
    plain = flash_attention_packed_bwd_reference(*ops, lse, do, h, pad_mask=pad, causal=causal, sm_scale=dqk**-0.5)
    f64 = flash_attention_packed_bwd_reference(*(t.double() for t in ops), lse.double(), do.double(), h,
                                               pad_mask=pad, causal=causal, sm_scale=dqk**-0.5)
    for got, p, e in zip((q.grad, k.grad, v.grad), plain, f64):
        assert got.dtype == torch.bfloat16
        _bf16_rule(got, p, e, 1.25)
    if nq > nkv:
        assert torch.equal(q.grad[:, : nq - nkv], torch.zeros_like(q.grad[:, : nq - nkv]))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", ["serve_ca", "serve_sa", "edges", "ca_retired", "skewed", "all_masked",
                                  "shared_pages", "micro_odd_page", "unaligned", "head_groups"])
def test_paged_decode_bf16_kernel_matches_plain(cuda, case, with_mask):
    """K3's bf16 build over bf16 pools (the bulk copies at half the bytes;
    2-byte element copies where rows are no multiple of 16 bytes) against
    the plain version: within 1e-2 of its largest magnitude, and no further
    from the f64 evaluation than the plain version (L2, plus 1e-6 of the
    output's size for the f32 sums' rounding), at the serve's CA and SA
    pools, a length-0 slot, an all-masked slot and the edge cases; one bf16
    launch a call."""
    from perceiver_io_tpu_torch.core.cache import PagedKVCache, init_paged_kv_cache
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    g = torch.Generator().manual_seed(1)
    slots, page, pps, h, d, lengths = PAGED_CASES[case]
    cache = init_paged_kv_cache(slots, 1 + slots * pps, page, pps, h * d, h * d, dtype=torch.bfloat16, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    table = (torch.randperm(slots * pps, generator=g) + 1).reshape(slots, pps).to(torch.int32)
    if case == "shared_pages":
        table[2, :3] = table[0, :3]
    if case == "ca_retired":
        table[0] = 0
    cache.page_table = table.to(cuda)
    cache.length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    qh = (torch.randn(slots, h, d, generator=g) * d**-0.5).to(cuda, torch.bfloat16)
    mask = None
    if with_mask:
        mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device=cuda)
        for s, n in enumerate(lengths):
            mask[s, : min(n, cache.capacity) // 3] = True
        if case == "all_masked":
            mask[0, : lengths[0]] = True
    build.reset_launches()
    got = paged_decode_attention(qh, cache, mask)
    assert build.LAUNCHES["paged_decode_bf16"] == 1 and build.LAUNCHES["paged_decode"] == 0
    assert got.dtype == torch.bfloat16
    plain = paged_attention_reference(qh, cache, mask)
    c64 = PagedKVCache(cache.k.double(), cache.v.double(), cache.page_table, cache.length)
    _bf16_rule(got, plain, paged_attention_reference(qh.double(), c64, mask), 1.0, slack=1e-6)
    assert float((got.float() - plain.float()).abs().max()) <= 1e-2 * float(plain.float().abs().max())


def test_paged_decode_takes_a_bf16_pool_of_heads_of_64(cuda):
    """A bf16 pool of heads of 64 (the flagship's) goes to K3's bf16 build
    through the attention layer; the gate that refuses heads of 192 (above)
    lets it through."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops import build

    layer = MultiHeadAttention(2, 128, 128, causal_attention=True, dtype=torch.bfloat16).to(cuda)
    cache = init_paged_kv_cache(2, 5, 8, 2, 128, 128, dtype=torch.bfloat16, device=cuda)
    cache.page_table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    cache.length[:] = 3
    x = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(7)).to(cuda, torch.bfloat16)
    build.reset_launches()
    with torch.no_grad():
        out = layer(x, x, kv_cache=cache)
    assert build.LAUNCHES["paged_decode_bf16"] == 1 and build.LAUNCHES["paged_decode"] == 0
    assert out.last_hidden_state.dtype == torch.bfloat16 and out.kv_cache.length.tolist() == [4, 4]


@pytest.mark.parametrize("rows", [16384, 15360])
def test_layer_norm_bf16_kernels_at_the_flagship_shapes(cuda, rows):
    """K1 (with its statistics at the training rows, 15360 x 512; without at
    the serving prompt, 16384 x 512) and K5 at 15360 x 512, bf16 activations:
    each output tuple no further from the f64 evaluation than 1.25x the
    bf16 plain version (L2 over the tuple), within 2e-2 of the plain
    version's largest magnitude, dgamma/dbeta within the f32 case's 5e-4 of
    the plain sums; one bf16 launch each."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.layernorm import (
        layer_norm_bwd_cuda,
        layer_norm_bwd_reference,
        layer_norm_cuda,
        layer_norm_reference_stats,
    )

    g = torch.Generator().manual_seed(21)
    c = 512
    x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to(cuda, torch.bfloat16)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    b = (0.1 * torch.randn(c, generator=g)).to(cuda)
    stats = rows == 15360
    build.reset_launches()
    got = layer_norm_cuda(x, w, b, 1e-5, torch.bfloat16, want_stats=stats)
    assert build.LAUNCHES["layer_norm_fwd_bf16"] == 1 and build.LAUNCHES["layer_norm_fwd"] == 0
    plain = layer_norm_reference_stats(x, w, b, 1e-5, torch.bfloat16)
    f64 = layer_norm_reference_stats(x.double(), w.double(), b.double(), 1e-5, torch.float64)
    n = 3 if stats else 1
    flat = lambda ts: torch.cat([t.double().reshape(-1) for t in ts[:n]])  # noqa: E731
    _bf16_rule(flat(got), flat(plain), flat(f64), 1.25)
    if not stats:
        return
    dy = torch.randn(rows, c, generator=g).to(cuda, torch.bfloat16)
    _, mean, rstd = got
    build.reset_launches()
    kernel = layer_norm_bwd_cuda(x, w, mean, rstd, dy)
    assert build.LAUNCHES["layer_norm_bwd_bf16"] == 1 and build.LAUNCHES["layer_norm_bwd"] == 0
    assert kernel[0].dtype == torch.bfloat16
    plain = layer_norm_bwd_reference(x, w, mean, rstd, dy)
    f64 = layer_norm_bwd_reference(x.double(), w.double(), mean.double(), rstd.double(), dy.double())
    _bf16_rule(torch.cat([t.double().reshape(-1) for t in kernel]), torch.cat([t.double().reshape(-1) for t in plain]),
               torch.cat([t.double().reshape(-1) for t in f64]), 1.25)
    for k_, p_ in zip(kernel[1:], plain[1:]):
        torch.testing.assert_close(k_, p_, atol=5e-4, rtol=0)


def test_bf16_graphed_train_step_equals_the_eager_step_bit_for_bit(cuda):
    """Three bf16 CLM train steps with bf16 Adam moments (microbatch 2, clip,
    a warmup-cosine schedule whose first rate is 0, fresh keep sets) as a
    CUDA graph and eagerly, from the same weights: the losses and every
    parameter, moment and the count after the third, bit for bit; every
    attention backward on K4's bf16 build."""
    from perceiver_io_tpu_torch.ops import build

    batches = _graph_batches(3)
    build.reset_launches()
    graphed, g_metrics, g_tensors = _graph_train_run(cuda, (), True, batches, dtype=torch.bfloat16,
                                                     moment_dtype="bfloat16")
    assert build.LAUNCHES["flash_packed_bwd_dq_bf16"] > 0 and build.LAUNCHES["flash_packed_bwd_dq"] == 0
    eager, e_metrics, e_tensors = _graph_train_run(cuda, (), False, batches, dtype=torch.bfloat16,
                                                   moment_dtype="bfloat16")
    assert [m["loss"] for m in g_metrics] == [m["loss"] for m in e_metrics]
    assert all(torch.equal(a, b) for a, b in zip(g_tensors[-1], e_tensors[-1]))
    assert all(t.dtype == torch.bfloat16 for t in graphed.optimizer.compact.mu)
    assert int(graphed.optimizer.count) == 3 and np.isfinite([m["loss"] for m in g_metrics]).all()


def test_capturable_compact_adamw_keeps_a_zero_gradient_row_at_a_zero_rate(cuda):
    """The compact update on the card (as a captured step runs it: rate and
    count on the device) against the CPU's, three updates from the same
    gradients under a warmup whose first rate is 0, one gradient row always
    0: no NaN anywhere (a form that divides by the rate turns such a row
    into NaN at rate 0), the zero row unchanged but for the decay, the
    bf16 moments bit for bit and the parameters within 1e-6."""
    from perceiver_io_tpu_torch import training as tt

    rng = np.random.default_rng(14)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((64, 32), (32,))]
    params = {dev: [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev)) for a in p0] for dev in ("cpu", cuda)}
    opts = {dev: tt.make_optimizer(tt.cosine_with_warmup(5e-2, 4, 1), weight_decay=0.0, gradient_clip=1.0,
                                   moment_dtype="bfloat16")(ps) for dev, ps in params.items()}
    for _ in range(3):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in p0]
        grads[0][0] = 0.0
        for dev, ps in params.items():
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g).to(dev)
            opts[dev].step()
    for got, want in zip(params[cuda], params["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-6, rtol=0)
    assert torch.equal(params[cuda][0][0].detach().cpu(), torch.from_numpy(p0[0][0]))
    for got, want in zip(opts[cuda].compact.mu + opts[cuda].compact.nu, opts["cpu"].compact.mu + opts["cpu"].compact.nu):
        assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# bf16: the image classifier's bf16 builds (K8, K9a/K9b) and its bf16 steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [40, 64, 128, 256, 264, 512])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (False, 130, 300, 0),   # no tile multiple
    (True, 130, 300, 7),    # Nq < Nkv right-aligned, left-padded keys
    (True, 300, 130, 0),    # Nq > Nkv: 170 rows see no key, zero gradient
    (False, 64, 4096, 0),   # a long kv walk split across CTAs (K8, K9b)
    (True, 100, 3000, 50),  # split and causal: some splits see nothing
])
def test_flash_heads_bf16_kernels_match_plain(cuda, d, causal, nq, nkv, n_pad):
    """K8, K9a and K9b's bf16 builds (bf16 mma.sync; p rounded to bf16 once
    before P V, p and dS before the gradient products) through the autograd
    Function, one bucket each (64: head dims 40, which is no multiple of 16,
    and 64; 128; 256; 288: the image CA's 264, whose last k-step is half
    zeros; 512): the output and each gradient no further from the plain
    version evaluated in f64 on the same bf16 inputs than 1.25x the bf16
    plain version (L2) and within 2e-2 of the plain version's largest
    magnitude; the logsumexp within 1e-4 of the plain one; one bf16 launch
    each and no f32 one."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    g = torch.Generator().manual_seed(15)
    b, h = 2, 2
    q = (torch.randn(b, h, nq, d, generator=g) * d**-0.5).to(cuda, torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, h, nkv, d, generator=g).to(cuda, torch.bfloat16).requires_grad_() for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g).to(cuda, torch.bfloat16)
    pad = torch.zeros(b, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    kw = dict(pad_mask=pad, causal=causal)
    build.reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    o.backward(do)
    assert [build.LAUNCHES[n + "_bf16"] for n in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] \
        == [1, 1, 1]
    assert build.LAUNCHES["flash_heads_fwd"] == build.LAUNCHES["flash_heads_bwd_dkv"] == 0
    assert o.dtype == q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16 and lse.dtype == torch.float32
    plain = [t.detach() for t in (q, k, v)]
    ro, rlse = flash_attention_reference(*plain, **kw)
    eo, _ = flash_attention_reference(*(t.double() for t in plain), **kw)
    _bf16_rule(o.detach(), ro, eo, 1.25)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    ops = (*plain, o.detach(), lse, do)
    want = flash_attention_bwd_reference(*ops, **kw)
    f64 = flash_attention_bwd_reference(*(t.double() for t in ops), **kw)
    for got, p, e in zip((q.grad, k.grad, v.grad), want, f64):
        _bf16_rule(got, p, e, 1.25)
    if causal and nq > nkv:
        assert torch.equal(q.grad[:, :, : nq - nkv], torch.zeros_like(q.grad[:, :, : nq - nkv]))


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("d", [8, 72, 200, 264, 288, 320, 512])
def test_flash_heads_bf16_kernels_every_bucket_split_and_unsplit(cuda, d, nsplit):
    """K8's and K9b's bf16 builds through their wrappers in every bucket
    (with its edges), their kv walks unsplit and split 3 ways (K8's merge
    and K9b's reduce write bf16 from f32 partials), and K9a beside them,
    under ``_bf16_rule`` (1.25x) against the plain versions; split and
    unsplit within one bf16 step of each other."""
    from perceiver_io_tpu_torch.ops import flash_attention as tflash

    g = torch.Generator().manual_seed(16)
    b, h, nq, nkv = 2, 1, 130, 1000
    q = (torch.randn(b, h, nq, d, generator=g) * d**-0.5).to(cuda, torch.bfloat16)
    k, v = (torch.randn(b, h, nkv, d, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g).to(cuda, torch.bfloat16)
    pad = torch.zeros(b, nkv, dtype=torch.bool, device=cuda)
    pad[0, :37] = True
    bias = tflash.bias_row(pad, b, nkv, q.device)
    qf, kf, vf = tflash._heads_layout(q, k, v)
    d8 = qf.shape[2]
    o, lse = tflash.heads_fwd_cuda(qf, kf, vf, h, bias, False, 1.0, nsplit=nsplit)
    assert o.dtype == torch.bfloat16
    ro, _ = tflash.flash_attention_reference(q, k, v, pad)
    eo, _ = tflash.flash_attention_reference(q.double(), k.double(), v.double(), pad)
    _bf16_rule(o[..., :d].reshape(ro.shape), ro, eo, 1.25)
    dof = torch.nn.functional.pad(do.reshape(b * h, nq, d), (0, d8 - d))
    args = (qf, kf, vf, dof, lse, (dof.float() * o.float()).sum(-1), h, bias, False, 1.0)
    dq = tflash.heads_bwd_dq_cuda(*args, nsplit=nsplit)
    dk, dv = tflash.heads_bwd_dkv_cuda(*args)
    o4, lse4 = o[..., :d].reshape(ro.shape), lse.reshape(b, h, nq)
    want = tflash.flash_attention_bwd_reference(q, k, v, o4, lse4, do, pad)
    f64 = tflash.flash_attention_bwd_reference(*(t.double() for t in (q, k, v, o4, lse4, do)), pad)
    for got, p, e in zip((dq, dk, dv), want, f64):
        _bf16_rule(got[..., :d].reshape(p.shape), p, e, 1.25)
    if nsplit > 1:
        o1, _ = tflash.heads_fwd_cuda(qf, kf, vf, h, bias, False, 1.0, nsplit=1)
        dq1 = tflash.heads_bwd_dq_cuda(*args, nsplit=1)
        for split, whole in ((o, o1), (dq, dq1)):
            # one bf16 rounding step apart at most, or a step of the largest
            # value where a result lies near 0
            atol = 2**-8 * float(whole.float().abs().max())
            torch.testing.assert_close(split.float(), whole.float(), atol=atol, rtol=2**-7)


def _bf16_image_run(cuda, jit: bool, steps: int = 3):
    """``steps`` AdamW steps (f32 moments, clip 1.0) of a small bf16 image
    classifier (split route) on fixed batches: (losses, parameters and
    moments after the last step, launches)."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig
    from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageClassifierConfig, ImageEncoderConfig
    from perceiver_io_tpu_torch.ops import build

    config = ImageClassifierConfig(
        encoder=ImageEncoderConfig(image_shape=(16, 16, 3), num_frequency_bands=32, num_cross_attention_heads=1,
                                   num_self_attention_heads=2, num_self_attention_layers_per_block=1,
                                   num_self_attention_blocks=2),
        decoder=ClassificationDecoderConfig(num_classes=4, num_output_query_channels=32,
                                            num_cross_attention_heads=1),
        num_latents=128, num_latent_channels=32,
    )
    model = ImageClassifier(config, dtype=torch.bfloat16, device=cuda, generator=torch.Generator().manual_seed(0))
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3, gradient_clip=1.0))
    step = tt.make_train_step(tt.classification_loss_fn(), sentinel=True, jit=jit)
    rng = np.random.default_rng(17)
    build.reset_launches()
    losses = []
    for _ in range(steps):
        batch = {"image": rng.normal(size=(4, 16, 16, 3)).astype(np.float32), "label": rng.integers(0, 4, size=4)}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, [t.detach().clone() for t in state.optimizer.state_tensors()], dict(build.LAUNCHES)


def test_bf16_image_graphed_train_step_equals_the_eager_step_bit_for_bit(cuda):
    """Three train steps of the bf16 image classifier with f32 Adam moments
    as a CUDA graph and eagerly, from the same weights and batches: the
    losses and every parameter and moment after the third step bit for bit;
    every step's cross-attention on K8, K9a and K9b's bf16 builds, once each,
    and no f32 build of them."""
    graphed = _bf16_image_run(cuda, True)
    eager = _bf16_image_run(cuda, False)
    assert graphed[0] == eager[0] and np.isfinite(graphed[0]).all()
    assert all(torch.equal(a, b) for a, b in zip(graphed[1], eager[1]))
    assert all(t.dtype == torch.float32 for t in graphed[1] if t.is_floating_point())
    for launches in (graphed[2], eager[2]):
        assert [launches[n + "_bf16"] for n in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] \
            == [3, 3, 3]
        assert launches["flash_heads_fwd"] == launches["flash_heads_bwd_dkv"] == launches["flash_heads_bwd_dq"] == 0


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b,h,n_p,nq,n_pad,bwd", [
    (2, 4, 1, 100, 0, True),      # the minimum prefix; Nq no tile multiple
    (2, 4, 70, 130, 5, True),     # the seam inside a tile; left-padded prefix keys; Np no tile multiple
    (2, 4, 200, 128, 0, True),
    (2, 4, 129, 37, 100, True),   # a prefix of two tiles and one row, mostly padded
    (1, 8, 5000, 130, 0, False),  # the eval window's kind of call: the walk split, the partials merged
    (1, 8, 5000, 130, 4500, False),
])
def test_flash_2seg_bf16_kernels_match_plain(cuda, d, b, h, n_p, nq, n_pad, bwd):
    """K6, K7a and K7b's bf16 builds (bf16 mma.sync; K6 keeps p in two bf16
    parts, K7 rounds p and dS to bf16 before the gradient products) through
    the autograd Function: the output and each of the five gradients no
    further from the plain version evaluated in f64 on the same bf16 inputs
    than 1.25x the bf16 plain version (L2), and within 2e-2 of the plain
    version's largest magnitude; the logsumexp within 1e-4 of the plain
    version's; one bf16 launch each, no f32 one."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed_2seg,
        flash_attention_packed_2seg_bwd_reference,
        flash_attention_packed_2seg_reference,
        packed_kv_splits,
    )

    g = torch.Generator().manual_seed(17)
    if not bwd:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert packed_kv_splits(b, h, nq, n_p + nq, d, sms, torch.bfloat16) > 1
    bf16 = torch.bfloat16
    q = (torch.randn(b, nq, h * d, generator=g) * d**-0.5).to(cuda, bf16).requires_grad_()
    k_l, v_l = (torch.randn(b, nq, h * d, generator=g).to(cuda, bf16).requires_grad_() for _ in range(2))
    k_p, v_p = (torch.randn(b, n_p, h * d, generator=g).to(cuda, bf16).requires_grad_() for _ in range(2))
    do = torch.randn(b, nq, h * d, generator=g).to(cuda, bf16)
    pad_p = torch.zeros(b, n_p, dtype=torch.bool, device=cuda)
    pad_p[-1, :n_pad] = True
    ops = (q, k_p, v_p, k_l, v_l)
    kw = dict(pad_mask_prefix=pad_p)
    build.reset_launches()
    o, lse = flash_attention_packed_2seg(*ops, h, return_lse=True, **kw)
    if bwd:
        o.backward(do)
    torch.cuda.synchronize()
    names = ("flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq")
    assert [build.LAUNCHES[k + "_bf16"] for k in names] == [1, int(bwd), int(bwd)]
    assert all(build.LAUNCHES[k] == 0 for k in names)
    plain = [t.detach() for t in ops]
    ro, rlse = flash_attention_packed_2seg_reference(*plain, h, **kw)
    eo, _ = flash_attention_packed_2seg_reference(*(t.double() for t in plain), h, **kw)
    assert o.dtype == bf16
    _bf16_rule(o.detach(), ro, eo, 1.25)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    if not bwd:
        return
    want = flash_attention_packed_2seg_bwd_reference(*plain, o.detach(), lse, do, h, **kw)
    f64 = flash_attention_packed_2seg_bwd_reference(*(t.double() for t in (*plain, o.detach(), lse, do)), h, **kw)
    for x, p, e in zip(ops, want, f64):
        assert x.grad.dtype == bf16
        _bf16_rule(x.grad, p, e, 1.25)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,n_pad", [(True, 0), (True, 3001), (False, 0)])
def test_flash_packed_bf16_split_walk_matches_plain(cuda, d, causal, n_pad):
    """K2's bf16 build takes the kv split (the merge writes bf16): the
    serving prefill's kind of call (batch 1, 8 heads, 512 queries over 4100
    keys), against the plain version evaluated in f64 (1.25x the bf16 plain
    version, L2), the logsumexp within 1e-4; and the unsplit walk
    (``_fwd_cuda(..., nsplit=1)``) within the same rule."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        _fwd_cuda,
        bias_row,
        flash_attention_packed,
        flash_attention_packed_reference,
        packed_kv_splits,
    )

    g = torch.Generator().manual_seed(12)
    h, nq, nkv = 8, 512, 4100
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert packed_kv_splits(1, h, nq, nkv, d, sms, torch.bfloat16) > 1
    q = (torch.randn(1, nq, h * d, generator=g) * d**-0.5).to(cuda, torch.bfloat16)
    k, v = (torch.randn(1, nkv, h * d, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    pad = torch.zeros(1, nkv, dtype=torch.bool, device=cuda)
    pad[:, :n_pad] = True
    build.reset_launches()
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, return_lse=True)
    assert build.LAUNCHES["flash_packed_fwd_bf16"] == 1 and o.dtype == torch.bfloat16
    ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal)
    eo, _ = flash_attention_packed_reference(q.double(), k.double(), v.double(), h, pad_mask=pad, causal=causal)
    _bf16_rule(o, ro, eo, 1.25)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    uo, ulse = _fwd_cuda(q, k, v, h, bias_row(pad, 1, nkv, cuda), causal, 1.0, nsplit=1)
    _bf16_rule(uo, ro, eo, 1.25)
    torch.testing.assert_close(ulse, rlse, atol=1e-4, rtol=0)


_DECODE_CLM = dict(vocab_size=262, max_seq_len=64, max_latents=16, num_channels=64, num_heads=4,
                   num_self_attention_layers=2)


@pytest.mark.parametrize("dtype,cache_dtype,sample", [
    (torch.float32, torch.float32, False),
    (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, True),
], ids=["f32", "f32_sampled", "bf16_f32_cache", "bf16_bf16_cache_sampled"])
def test_decode_pair_graph_equals_eager(cuda, dtype, cache_dtype, sample):
    """``make_decode_fns``' step on the card is a captured CUDA graph; its
    stream equals the eager body's (``generation._eager_step``, the same
    draws) token for token over 20 steps, the prompt filling both windows so
    that they slide at every step, and its logits the eager step's within
    2^-8 of their largest magnitude (the same kernels; cuBLAS may pick
    another GEMM algorithm under capture, and a bf16 logit is 2^-8 wide);
    ``generate`` gives the same stream; the graph holds the step's kernels
    (K1's nodes, no K2, no K3); a call with another state raises."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**_DECODE_CLM), device=cuda, dtype=dtype,
                                generator=torch.Generator().manual_seed(0))
    config = generation.GenerationConfig(max_new_tokens=21, do_sample=sample, temperature=0.8, top_k=40,
                                         eos_token_id=5 if sample else None)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 262, size=(2, 64))
    pad = np.zeros((2, 64), bool)
    pad[1, :9] = True
    prefill, step = generation.make_decode_fns(model, 16, config, cache_dtype, device=cuda)
    streams, logits = {}, {}
    for name in ("graph", "eager"):
        body = step if name == "graph" else generation._eager_step(model, config, cuda)
        token, state = prefill(ids, pad, torch.Generator().manual_seed(7))
        streams[name], logits[name] = [token.clone()], []
        for _ in range(20):
            state, token = body(state)
            streams[name].append(token.clone())
            logits[name].append(state["logits"].clone())
        assert int(state["ca_start"]) == 20 and int(state["sa_start"]) == 20
    assert all(torch.equal(a, b) for a, b in zip(streams["graph"], streams["eager"]))
    for a, b in zip(logits["graph"], logits["eager"]):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).abs().max()) <= 2**-8 * float(b.float().abs().max())
    out = generation.generate(model, ids, 16, pad_mask=pad, config=config, generator=torch.Generator().manual_seed(7),
                              cache_dtype=cache_dtype, device=cuda)
    assert torch.equal(out[:, 64:], torch.stack(streams["eager"], dim=1))
    assert isinstance(step.body, generation._GraphedStep)
    nodes = step.body.graph.kernel_nodes(["_layer_norm_fwd_kernel", "flash_packed_kernel", "paged_walk_kernel"])
    assert nodes["_layer_norm_fwd_kernel"] > 0 and nodes["flash_packed_kernel"] == nodes["paged_walk_kernel"] == 0
    with pytest.raises(ValueError, match="another state"):
        step(prefill(ids, pad)[1])


# ---------------------------------------------------------------------------
# the training options: prefix-dropout mask mode, dropout, checkpointing and
# offloading, the optimizers, in captured steps
# ---------------------------------------------------------------------------


def _scattered_drop(g, b, n_p, keep):
    """A "mask"-mode drop mask (b, n_p): ``keep`` rows kept per row, drawn
    from ``g``, the rest masked where they lie."""
    kept = torch.stack([torch.randperm(n_p, generator=g)[:keep] for _ in range(b)])
    return torch.ones(b, n_p, dtype=torch.bool).scatter_(1, kept, False)


@pytest.mark.parametrize("kernels", ["packed", "2seg"])
def test_mask_mode_kernels_match_plain(cuda, kernels):
    """The "mask" prefix-dropout mode's call shape, bf16 as its flagship
    phase runs it: K2/K4a/K4b over [prefix; latents] with half the prefix
    keys masked where they lie (a scattered kv bias), and K6/K7a/K7b with
    the same as a scattered prefix bias; each output and gradient held to
    the bf16 rule (1.25x the bf16 plain version's L2 distance from the f64
    evaluation), the logsumexp within 1e-4."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_2seg,
        flash_attention_packed_2seg_bwd_reference,
        flash_attention_packed_2seg_reference,
        flash_attention_packed_bwd_reference,
        flash_attention_packed_reference,
    )

    g = torch.Generator().manual_seed(21)
    bf16, b, h, d, n_p, nq = torch.bfloat16, 2, 4, 64, 1000, 128
    drop = _scattered_drop(g, b, n_p, n_p // 2).to(cuda)
    q = (torch.randn(b, nq, h * d, generator=g) * d**-0.5).to(cuda, bf16).requires_grad_()
    k_p, v_p, k_l, v_l = ((torch.randn(b, n, h * d, generator=g)).to(cuda, bf16).requires_grad_()
                          for n in (n_p, n_p, nq, nq))
    do = torch.randn(b, nq, h * d, generator=g).to(cuda, bf16)
    build.reset_launches()
    if kernels == "packed":
        k, v = (torch.cat([a, c], dim=1).detach().requires_grad_() for a, c in ((k_p, k_l), (v_p, v_l)))
        pad = torch.cat([drop, torch.zeros(b, nq, dtype=torch.bool, device=cuda)], dim=1)
        ops, kw = (q, k, v), dict(pad_mask=pad, causal=True)
        o, lse = flash_attention_packed(*ops, h, return_lse=True, **kw)
        ref, bwd_ref, names = flash_attention_packed_reference, flash_attention_packed_bwd_reference, (
            "flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq")
    else:
        ops, kw = (q, k_p, v_p, k_l, v_l), dict(pad_mask_prefix=drop)
        o, lse = flash_attention_packed_2seg(*ops, h, return_lse=True, **kw)
        ref, bwd_ref, names = flash_attention_packed_2seg_reference, flash_attention_packed_2seg_bwd_reference, (
            "flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq")
    o.backward(do)
    torch.cuda.synchronize()
    assert [build.LAUNCHES[k + "_bf16"] for k in names] == [1, 1, 1]
    plain = [t.detach() for t in ops]
    ro, rlse = ref(*plain, h, **kw)
    _bf16_rule(o.detach(), ro, ref(*(t.double() for t in plain), h, **kw)[0], 1.25)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    want = bwd_ref(*plain, o.detach(), lse, do, h, **kw)
    f64 = bwd_ref(*(t.double() for t in (*plain, o.detach(), lse, do)), h, **kw)
    for x, p, e in zip(ops, want, f64):
        _bf16_rule(x.grad, p, e, 1.25)


@pytest.mark.parametrize("route", [(), ("twoseg",)], ids=["concat", "twoseg"])
@pytest.mark.parametrize("remat", ["activation_checkpointing", "activation_offloading"])
def test_graphed_remat_train_step_equals_the_plain_step_bit_for_bit(cuda, route, remat):
    """Three bf16 CLM train steps with checkpointing or offloading (the
    recompute inside the captured backward; the offloaded projections in
    pinned host buffers the warm-up step allocated) as a CUDA graph and
    eagerly: the losses and every parameter, moment and the count after the
    third equal the plain step's bit for bit, graph against graph and eager
    against eager, and the graph's equal the eager run's."""
    from perceiver_io_tpu_torch.ops import build

    batches = _graph_batches(3, seed=12)
    runs = {}
    for name, options in (("plain", {}), ("remat", {remat: True})):
        for jit in (True, False):
            build.reset_launches()
            _, metrics, tensors = _graph_train_run(cuda, route, jit, batches, dtype=torch.bfloat16,
                                                   moment_dtype="bfloat16", options=options)
            runs[name, jit] = ([m["loss"] for m in metrics], tensors[-1], dict(build.LAUNCHES))
    for jit in (True, False):
        assert runs["remat", jit][0] == runs["plain", jit][0]
        assert all(torch.equal(a, b) for a, b in zip(runs["remat", jit][1], runs["plain", jit][1]))
    assert runs["remat", True][0] == runs["remat", False][0]
    # the recompute launches each layer's LayerNorms once more
    assert runs["remat", False][2]["layer_norm_fwd_bf16"] == 2 * runs["plain", False][2]["layer_norm_fwd_bf16"]


def test_graphed_dropout_train_step_equals_eager_and_redraws(cuda):
    """Attention and residual dropout (0.1) from a CUDA generator: three bf16
    steps as a graph equal the eager steps from the same generator state bit
    for bit, no attention kernel runs (the dense route), and at a rate of 0
    on one batch each replay draws other masks (other losses)."""
    from perceiver_io_tpu_torch.ops import build

    options = dict(post_attention_dropout=0.1, residual_dropout=0.1)
    batches = _graph_batches(3, seed=13)
    runs = {}
    for jit in (True, False):
        build.reset_launches()
        _, metrics, tensors = _graph_train_run(cuda, (), jit, batches, dtype=torch.bfloat16,
                                               moment_dtype="bfloat16", options=options)
        runs[jit] = ([m["loss"] for m in metrics], tensors[-1])
        assert build.LAUNCHES["flash_packed_fwd_bf16"] == 0 and build.LAUNCHES["layer_norm_fwd_bf16"] > 0
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    _, metrics, _ = _graph_train_run(cuda, (), True, batches[:1] * 3, dtype=torch.bfloat16,
                                     moment_dtype="bfloat16", options=options, lr=0.0)
    losses = [m["loss"] for m in metrics]
    assert len(set(losses)) == 3, losses


def test_graphed_mask_mode_train_step_equals_eager(cuda):
    """The "mask" prefix-dropout mode (the full prefix, the dropped rows in
    the pad mask) in three bf16 steps on both routes: graph equal to eager
    bit for bit, and each loss within 1e-2 of the gather mode's on the same
    keep sets (the kernels walk other tiles; see chip_smoke.py's
    MASK_LOSS_TOL_BF16)."""
    batches = _graph_batches(3, seed=14)
    for route in ((), ("twoseg",)):
        runs = {}
        for mode in ("gather", "mask"):
            for jit in (True, False):
                _, metrics, tensors = _graph_train_run(cuda, route, jit, batches, dtype=torch.bfloat16,
                                                       moment_dtype="bfloat16", options=dict(prefix_dropout_mode=mode))
                runs[mode, jit] = ([m["loss"] for m in metrics], tensors[-1])
        assert runs["mask", True][0] == runs["mask", False][0]
        assert all(torch.equal(a, b) for a, b in zip(runs["mask", True][1], runs["mask", False][1]))
        np.testing.assert_allclose(runs["mask", True][0], runs["gather", True][0], atol=1e-2, rtol=0)


@pytest.mark.parametrize("optim", [
    dict(optimizer="adam"), dict(optimizer="adam", moment_dtype="bfloat16"), dict(optimizer="lamb"),
    dict(optimizer="sgd"), dict(optimizer="adamw", accumulate_grad_batches=2),
], ids=["adam", "adam_bf16", "lamb", "sgd", "adamw_accumulate2"])
def test_graphed_optimizers_equal_the_eager_step_bit_for_bit(cuda, optim):
    """Four bf16 CLM train steps (the sentinel on) with each optimizer as a
    CUDA graph and eagerly: losses and every state tensor (parameters,
    moments, the running mean and optax's step counters) bit for bit."""
    optim = dict(optim)
    moments = optim.pop("moment_dtype", None)
    batches = _graph_batches(4, seed=15)
    runs = {}
    for jit in (True, False):
        state, metrics, tensors = _graph_train_run(cuda, (), jit, batches, sentinel=True, dtype=torch.bfloat16,
                                                   moment_dtype=moments, optim=optim)
        runs[jit] = ([m["loss"] for m in metrics], tensors[-1])
    assert runs[True][0] == runs[False][0] and np.isfinite(runs[True][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    assert state.step == 4


def test_dropped_captured_steps_release_their_memory(cuda):
    """Captured train steps made and dropped one after another leave no
    device memory behind: every capture shares one side stream a device
    (``graphs.capture_stream``). A stream each kept torch's per-stream cuBLAS
    workspace, 65 MiB on an H100, for every step dropped."""
    import gc

    from perceiver_io_tpu_torch import graphs

    batches = _graph_batches(2, seed=16)
    held = []
    for _ in range(3):
        _graph_train_run(cuda, (), True, batches, dtype=torch.bfloat16, moment_dtype="bfloat16")
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[2] == held[1] == held[0], held
    assert len(graphs._CAPTURE_STREAMS) == 1


# ---------------------------------------------------------------------------
# the trainer on the card (ROADMAP A5)
# ---------------------------------------------------------------------------


def _fit_state(device, dtype=torch.float32, moment_dtype=None, seed=0):
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM), device=device,
                                generator=torch.Generator().manual_seed(seed), dtype=dtype)
    return tt.TrainState.create(model, tt.make_optimizer(tt.cosine_with_warmup(1e-3, 8, 2), gradient_clip=1.0,
                                                         moment_dtype=moment_dtype),
                                generator=torch.Generator(device=device).manual_seed(5))


def _fit(root, state, batches, val=None, resume=False, hook=None, **cfg):
    """A fit of ``state`` on ``batches`` logging to ``root``; returns the
    state, each step's loss (as the step returned it) and the trainer's
    captured train step."""
    from perceiver_io_tpu_torch import training as tt

    settings = dict(max_steps=len(batches), log_interval=2, microbatch=2, sentinel=True,
                    checkpoint_dir=str(root / "ckpt"))
    settings.update(cfg)
    tr = tt.Trainer(tt.clm_loss_fn(128), config=tt.TrainerConfig(**settings),
                    logger=tt.MetricsLogger(str(root / "logs"), use_tensorboard=False))
    losses, orig = [], tr._train_step

    def wrapped(state, batch):
        state, metrics = orig(state, batch)
        losses.append(metrics["loss"])
        if hook is not None:
            hook(tr, state)
        return state, metrics

    tr._train_step = wrapped
    out = tr.fit(state, iter(batches), val_loader=val, resume=resume)
    tr.close()
    return out, [float(x) for x in losses], orig.captured


def test_micro_fit_on_the_card_matches_the_cpu_fit(cuda, tmp_path):
    """``Trainer.fit`` (6 steps, validation every 3, the captured steps, the
    double buffer) on the card against the same fit on the CPU's plain
    versions: each loss and validation loss within 1e-5 relative, each
    parameter within 1e-5 of its largest value (the card's gradients are
    within 1e-4 relative of the CPU's; AdamW at 1e-3 takes them through six
    steps)."""
    import csv

    batches, val = _graph_batches(6, seed=20), _graph_batches(1, seed=21)
    runs = {}
    for dev in ("cpu", cuda):
        state, losses, _ = _fit(tmp_path / str(dev), _fit_state(dev), batches, val=val, val_interval=3)
        with open(tmp_path / str(dev) / "logs" / "metrics.csv", newline="") as f:
            vals = [float(r["val_loss"]) for r in csv.DictReader(f) if r["val_loss"]]
        runs[str(dev)] = (losses, vals, {n: p.detach().cpu() for n, p in state.model.named_parameters()})
    (cl, cv, cp), (gl, gv, gp) = runs["cpu"], runs[str(cuda)]
    assert len(cv) == len(gv) == 2
    np.testing.assert_allclose(gl + gv, cl + cv, rtol=1e-5)
    for name, want in cp.items():
        err = float((gp[name] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)


def test_resume_on_the_card_is_bit_for_bit(cuda, tmp_path):
    """bf16 compute and moments, batches WITHOUT keep sets, so the captured
    step draws them on the card from the state's CUDA generator (registered
    with the graph): a fit preempted at step 3 and resumed by a fresh Trainer
    into a fresh state (another generator seed) equals the uninterrupted fit
    bit for bit: losses, every optimizer tensor and the generator state."""
    batches = [{k: v for k, v in b.items() if k != "prefix_keep_idx"} for b in _graph_batches(6, seed=22)]
    kw = dict(dtype=torch.bfloat16, moment_dtype="bfloat16")
    ref, ref_losses, _ = _fit(tmp_path / "ref", _fit_state(cuda, **kw), batches)

    def trip(tr, state):
        if state.step == 3:
            tr._preempt_guard.trip()

    _, part1, _ = _fit(tmp_path / "run", _fit_state(cuda, **kw), batches, hook=trip)
    fresh = _fit_state(cuda, seed=1, **kw)
    fresh.generator.manual_seed(77)
    out, part2, _ = _fit(tmp_path / "run", fresh, batches, resume="auto")
    assert part1 + part2 == ref_losses and len(part1) == 3
    assert all(torch.equal(a, b) for a, b in zip(out.optimizer.state_tensors(), ref.optimizer.state_tensors()))
    assert torch.equal(out.generator.get_state(), ref.generator.get_state())
    assert len(set(ref_losses)) == 6


def test_rollback_on_the_card_does_not_recapture(cuda, tmp_path):
    """Two NaN steps after a checkpoint roll the fit back: the checkpoint is
    copied into the captured step's own tensors (every parameter and
    optimizer tensor keeps its address, the values are the checkpoint's),
    the train step keeps its one capture and graph, and the fit finishes."""
    from perceiver_io_tpu_torch import training as tt

    batches = _graph_batches(11, seed=23)  # 8 steps and the 3 the rollback replays
    for i, b in enumerate(batches):
        b["poison"] = np.full(4, np.nan if i in (4, 5) else 1.0, np.float32)

    def poisoned(model, batch, generator=None):
        loss, _ = tt.clm_loss_fn(128)(model, batch, generator)
        loss = loss * batch["poison"][0]
        return loss, {"loss": loss}

    tr = tt.Trainer(poisoned, eval_loss_fn=tt.clm_loss_fn(128, deterministic=True), config=tt.TrainerConfig(
        max_steps=8, log_interval=2, val_interval=3, microbatch=2, checkpoint_dir=str(tmp_path / "ckpt"),
        sentinel=tt.SentinelConfig(skip_limit=2)), logger=tt.MetricsLogger(str(tmp_path / "logs"),
                                                                          use_tensorboard=False))
    step, restore = tr._train_step, tr.checkpoints.restore
    graphs, at_rollback = [], []

    def tracked_restore(st, at=None):
        out = restore(st, at)
        at_rollback.append(([t.clone() for t in out.optimizer.state_tensors()],
                            tr.checkpoints._load_payload(tr.checkpoints.last_restore["step"])))
        return out

    def tracked_step(st, b):
        st, m = step(st, b)
        graphs.append(step.captured.graph)
        return st, m

    tr.checkpoints.restore, tr._train_step = tracked_restore, tracked_step
    state = _fit_state(cuda)
    ptrs = [t.data_ptr() for t in list(state.model.state_dict().values()) + state.optimizer.state_tensors()]
    out = tr.fit(state, iter(batches), val_loader=_graph_batches(1, seed=24))
    tr.close()
    assert out is state and out.step == 8
    assert [t.data_ptr() for t in list(state.model.state_dict().values()) + state.optimizer.state_tensors()] == ptrs
    assert step.captured.captures == 1 and len({id(g) for g in graphs}) == 1
    ((tensors, saved),) = at_rollback
    assert saved["step"] == 3
    names = [name for name, _ in state.model.named_parameters()]
    assert all(torch.equal(t.cpu(), saved["model"][name]) for name, t in zip(names, tensors))
    assert all(torch.equal(t.cpu(), w) for t, w in zip(tensors[len(names):], saved["optimizer"]))


def test_double_buffered_fit_equals_the_unbuffered_fit(cuda, tmp_path):
    """The input double buffer (the next batch's pinned copies on the copy
    stream, the wait and ``record_stream`` before the step reads them) gives
    the losses and parameters of the fit without it, bit for bit, with fresh
    batches every step (a batch read before its copy landed, or from memory
    the allocator reused, would not)."""
    batches = _graph_batches(8, seed=25)
    runs = {}
    for buffered in (False, True):
        state, losses, _ = _fit(tmp_path / str(buffered), _fit_state(cuda, torch.bfloat16, "bfloat16"), batches,
                                input_double_buffer=buffered, prefetch_batches=2)
        runs[buffered] = (losses, [p.detach().clone() for p in state.model.parameters()])
    assert runs[True][0] == runs[False][0] and len(set(runs[True][0])) == 8
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


def test_a_capture_survives_the_collector_freeing_a_dropped_graph(cuda):
    """A captured graph held in a reference cycle turns into garbage while
    another capture records, and the collector is due then (its thresholds
    at 1, the captured function allocating): the capture still succeeds,
    and the old graph is freed after it. Destroying a CUDA graph is refused
    while a stream captures; before ``graphs.Graph`` paused automatic
    collection for its capture, that ended the capture with CUDA error 901
    (a flagship serve's decode pair failed so, its five earlier pairs' graphs
    collected mid-capture)."""
    import gc

    from perceiver_io_tpu_torch import graphs

    stream = graphs.capture_stream(cuda)
    x = torch.arange(4.0, device=cuda)
    cycle = {"graph": graphs.Graph(lambda: x * 2, "old", stream)}
    cycle["self"] = cycle
    keep = [cycle]
    del cycle

    def body():
        keep.clear()  # the cycle, and the graph in it, is garbage from here on
        junk = [[i] for i in range(20000)]  # allocations that make the collector due
        return x + len(junk)

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = graphs.Graph(body, "new", stream)
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    assert torch.equal(graph.replay(), x + 20000)


# the admission tier (ROADMAP A6): chip_smoke.py's fault plan at micro size
_ADMISSION_CLM = dict(vocab_size=64, max_seq_len=64, max_latents=16, num_channels=64, num_heads=4,
                      num_self_attention_layers=2)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def admission_runs():
    """The plan through the engine on the card and on the CPU, from the same
    weights: each run's books, streams, captures, launches and, on the card,
    the parameters before and after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from perceiver_io_tpu_torch import serving
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.obs.events import EventLog, validate_events
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.training.faults import PreemptionGuard, RetryPolicy
    import tempfile

    cs = _chip_smoke()
    config = CausalLanguageModelConfig(**_ADMISSION_CLM)
    cpu_model = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        model = cpu_model
        if device == "cuda":
            model = CausalLanguageModel(config, device="cuda")
            model.load_state_dict(cpu_model.state_dict())
        before = {k: v.clone() for k, v in model.state_dict().items()}
        addresses = {k: v.data_ptr() for k, v in model.state_dict().items()}
        clock = serving.ManualClock()
        with tempfile.TemporaryDirectory() as out:
            engine = serving.EngineFrontEnd(
                model, num_latents=8, device=device, events=EventLog(out, main_process=True), clock=clock,
                sleep=clock.sleep, injector=cs.admission_faults(serving.FaultInjector(clock=clock)),
                config=cs.admission_config(serving, RetryPolicy),
                engine_config=serving.EngineConfig(slots=4, page_size=16, max_ca_tokens=64, max_sa_tokens=32))
            specs = cs.admission_specs(serving.RequestSpec, 64, (20, 40), (8, 12), 64)
            build.reset_launches()
            cs.admission_drive(engine, specs, clock, PreemptionGuard())
            cs.check_admission_books(device, engine)
            runs[device] = dict(
                books=engine.books(), served=dict(engine.served_tokens), steps=engine._engine_steps,
                launches=dict(build.LAUNCHES), captures=getattr(engine._step_fn.captured, "captures", None),
                problems=validate_events(out, warnings_out=[]) + engine.audit(),
                unchanged=all(torch.equal(v, before[k]) for k, v in model.state_dict().items()),
                addresses={k: v.data_ptr() for k, v in model.state_dict().items()} == addresses,
                pages=(engine.ca_alloc.pages_used, engine.sa_alloc.pages_used))
    runs["poisoned"] = cs.ADMISSION_POISONED
    return runs


def test_admission_plan_books_as_planned_on_the_card(admission_runs):
    card, cpu = admission_runs["cuda"], admission_runs["cpu"]
    assert card["problems"] == [] and card["pages"] == (0, 0)
    assert card["books"] == cpu["books"] and card["steps"] == cpu["steps"]


def test_admission_plan_captures_once_across_kill_cancel_and_timeout(admission_runs):
    """One capture at construction serves every step of the plan: its kill,
    cancel, timeout, prefill failure and drain retire slots in place."""
    card = admission_runs["cuda"]
    assert card["captures"] == 1
    assert card["launches"]["paged_decode"] == (1 + _ADMISSION_CLM["num_self_attention_layers"]) * card["steps"]


def test_admission_poisoned_prefill_restores_the_parameters_on_the_card(admission_runs):
    card = admission_runs["cuda"]
    assert card["unchanged"] and card["addresses"]


def test_admission_ok_streams_equal_the_cpu(admission_runs):
    card, cpu, poisoned = admission_runs["cuda"], admission_runs["cpu"], admission_runs["poisoned"]
    assert {i: s for i, s in card["served"].items() if i != poisoned} == {
        i: s for i, s in cpu["served"].items() if i != poisoned}


# prefix sharing, eviction and journal recovery (ROADMAP A7 + A8), at micro
# size: 8 latents, pages of 16, the no-slide geometry of _ADMISSION_CLM
_SHARE_ENGINE = dict(slots=4, page_size=16, max_ca_tokens=64, max_sa_tokens=16)


def _twin_models(dtype=torch.float32):
    """The micro CLM on the CPU and the same weights on the card."""
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    config = CausalLanguageModelConfig(**_ADMISSION_CLM)
    cpu = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(0), dtype=dtype)
    card = CausalLanguageModel(config, device="cuda", dtype=dtype)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shared_prefill_on_the_card_matches_the_cpu(cuda, dtype):
    """``make_shared_prefill_fn`` on the card (K2 over the filled CA cache,
    K2 for each SA layer: 3 launches) against the same call on the CPU (the
    plain versions), from the same weights, pool and pages: the first token
    equal, the logits and every cache within 2e-5 in f32, within 1e-2 (L2,
    relative) in bf16."""
    from perceiver_io_tpu_torch.generation import GenerationConfig, make_prefill_fn, make_shared_prefill_fn
    from perceiver_io_tpu_torch.ops import build

    cpu, card = _twin_models(dtype)
    cfg = GenerationConfig(max_new_tokens=4)
    prompt = np.random.default_rng(3).integers(0, 64, size=(1, 40))
    skip, ps, nl = 32, 16, 8
    _, ref = make_prefill_fn(cpu, nl, cfg, dtype, device="cpu")(prompt)
    pool_k = torch.zeros((5, ps, 64), dtype=dtype)
    pool_v = torch.zeros_like(pool_k)
    pool_k[[3, 1]] = ref["cache"][0].k[0, :skip].reshape(2, ps, 64)
    pool_v[[3, 1]] = ref["cache"][0].v[0, :skip].reshape(2, ps, 64)
    out = {}
    for device, model in (("cpu", cpu), ("cuda", card)):
        build.reset_launches()
        fn = make_shared_prefill_fn(model, nl, skip, 40, cfg, dtype, device=device)
        out[device] = fn(prompt[:, skip:], pool_k.to(device), pool_v.to(device), [3, 1])
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    assert build.LAUNCHES["flash_packed_fwd" + suffix] == 1 + _ADMISSION_CLM["num_self_attention_layers"]
    (tok_cpu, st_cpu), (tok_card, st_card) = out["cpu"], out["cuda"]
    assert int(tok_card[0]) == int(tok_cpu[0])
    pairs = [(st_card["logits"], st_cpu["logits"])]
    pairs += [(t_card, t_cpu) for c_card, c_cpu in zip(st_card["cache"], st_cpu["cache"])
              for t_card, t_cpu in ((c_card.k, c_cpu.k), (c_card.v, c_cpu.v))]
    for got, want in pairs:
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
        else:
            assert _rel_l2(got, want) < 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_span_over_a_filled_cache_runs_k2_on_the_card(cuda, dtype):
    """Eight queries appended to a cache that holds 200 rows (8 heads of
    64): one K2 launch over the 208 filled slots, no dense path, against
    the dense path over the slots on the card (causal, right-aligned):
    within 1e-5 in f32, 1e-2 in L2 relative in bf16."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
    from perceiver_io_tpu_torch.core.cache import init_kv_cache
    from perceiver_io_tpu_torch.ops import build

    g = torch.Generator().manual_seed(0)
    mha = MultiHeadAttention(8, 512, 512, causal_attention=True, dtype=dtype)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    mha.to(cuda)
    cache = init_kv_cache(1, 256, 512, 512, dtype, cuda)
    cache.k[:, :200] = torch.randn(1, 200, 512, generator=g).to(cuda, dtype)
    cache.v[:, :200] = torch.randn(1, 200, 512, generator=g).to(cuda, dtype)
    cache.length = 200
    x = torch.randn(1, 8, 512, generator=g).to(cuda, dtype)
    rope = torch.randn(1, 8, 32, generator=g).to(cuda)
    dense, calls = MultiHeadAttention._dense, []
    MultiHeadAttention._dense = lambda self, *a, **k: calls.append(1) or dense(self, *a, **k)
    try:
        build.reset_launches()
        with torch.no_grad():
            out = mha(x, x, rope_q=rope, rope_k=rope, kv_cache=cache)
        torch.cuda.synchronize()
    finally:
        MultiHeadAttention._dense = dense
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    assert calls == [] and build.LAUNCHES["flash_packed_fwd" + suffix] == 1 and out.kv_cache.length == 208
    with torch.no_grad():
        masked = (torch.arange(256, device=cuda) >= 208)[None, None, :] | MultiHeadAttention._causal(8, 256, 208, cuda)
        want = mha._proj(mha.o_proj, dense(mha, mha._proj(mha.q_proj, x), out.kv_cache.k, out.kv_cache.v, rope,
                                           masked))
    if dtype == torch.float32:
        torch.testing.assert_close(out.last_hidden_state, want, atol=1e-5, rtol=0)
    else:
        assert _rel_l2(out.last_hidden_state, want) < 1e-2


def _share_engine(model, device, **engine):
    from perceiver_io_tpu_torch import serving

    return serving.EngineFrontEnd(model, num_latents=8, device=device,
                                  engine_config=serving.EngineConfig(**{**_SHARE_ENGINE, **engine}))


def test_cow_fork_copies_in_place_under_the_captured_step(cuda):
    """A fork on the card copies the shared page into the fresh one inside
    the captured pools: the step's graph keeps its addresses (the next step
    replays without a capture), the copy is exact."""
    from perceiver_io_tpu_torch.generation import _state_tensors

    _, card = _twin_models()
    engine = _share_engine(card, "cuda")
    captured = engine._step_fn.captured
    bound = _state_tensors(engine._state)
    a = engine.ca_alloc
    g1 = a.alloc_tokens(32)
    g2 = a.alloc_tokens_shared(48, g1.pages)
    pool = engine._state["cache"][0]
    pool.k[g2.pages[1]] = 7.0
    forked = engine._fork_shared_append_page(g2, 20)
    fresh = forked.pages[1]
    assert fresh != g2.pages[1] and bool((pool.k[fresh] == 7.0).all()) and bool((pool.k[g2.pages[1]] == 7.0).all())
    assert _state_tensors(engine._state) == bound == captured._bound
    engine._step_fn(engine._state)
    assert captured.captures == 1
    for grant in (forked, g1):
        a.free(grant)


@pytest.mark.parametrize("mode", ["share", "evict"])
def test_share_and_evict_under_the_captured_step_equal_the_cpu(cuda, mode):
    """Shared-prefix joins ("share": six requests over one 32-token
    document) or evictions and resumes ("evict": eight requests in a pool at
    half headroom) on the card, through the step captured at construction:
    one capture (no recapture, ``RecompileTracker`` counts one compile), the
    hits or the evictions, the books and every stream equal to the same run
    on the CPU."""
    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec

    cpu, card = _twin_models()
    if mode == "share":
        specs = WorkloadSpec(seed=21, prompt_lens=(40, 48), max_new_tokens=(4, 8), shared_prefix_len=32).draw(6, 64)
        engine = {}
    else:
        specs = WorkloadSpec(seed=13, prompt_lens=(24, 40), max_new_tokens=(4, 8)).draw(8, 64)
        engine = dict(eviction=True, pool_headroom=0.5)
    runs = {}
    for device, model in (("cpu", cpu), ("cuda", card)):
        fe = _share_engine(model, device, **engine)
        fe.run_closed(specs, concurrency=len(specs))
        runs[device] = (fe.books(), dict(fe.served_tokens), fe._n_prefix_hits, fe.sharing_audit(), fe.audit())
        if device == "cuda":
            assert fe._step_fn.captured.captures == 1 and fe._tracker.total_compiles == 1
    books, served, hits, sharing, audit = runs["cuda"]
    assert runs["cuda"] == runs["cpu"] and sharing == [] and audit == [] and books["balanced"]
    assert (hits >= 1) if mode == "share" else (books["evictions"] >= 1 and books["resumes"] == books["evictions"])


# ---------------------------------------------------------------------------
# speculative decode and beam search as CUDA graphs
# ---------------------------------------------------------------------------

_SPEC_ENGINE = dict(slots=4, page_size=16, max_ca_tokens=64, max_sa_tokens=16, spec_k=3, spec_depth=1)


def _spec_engine(model, device, **engine):
    from perceiver_io_tpu_torch import serving

    return serving.EngineFrontEnd(model, num_latents=8, device=device,
                                  engine_config=serving.EngineConfig(**{**_SPEC_ENGINE, **engine}))


def _recorded(engine, rows):
    """Wrap the engine's step to keep each step's tokens, m, every pool's
    length and every pool's bytes (copies, before the host retires)."""
    step = engine._step_fn

    def recorded(state):
        state, tokens, m = step(state)
        pools = state["cache"] + state["draft_cache"]
        rows.append((tokens.clone(), m.clone(), [p.length.clone() for p in pools],
                     [(p.k.clone(), p.v.clone()) for p in pools]))
        return state, tokens, m

    engine._step_fn = recorded


def test_spec_engine_graph_equals_the_eager_step_bit_for_bit(cuda):
    """The speculative engine step captured at construction against the
    same step run eagerly (``generation._eager_step`` on its body and draw
    stage) over the same ragged requests: every step's tokens, m, every
    length and every pool row (the flagship's and the drafter's) bit for
    bit, and the streams equal."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec

    _, card = _twin_models()
    specs = WorkloadSpec(seed=13, prompt_lens=(24, 40), max_new_tokens=(4, 8)).draw(8, 64)
    runs = {}
    for kind in ("graph", "eager"):
        fe = _spec_engine(card, "cuda")
        captured = fe._step_fn.captured
        assert isinstance(captured, generation._GraphedStep) and captured.captures == 1
        if kind == "eager":
            fe._step_fn = generation._eager_step(card, fe._gen_config, cuda, captured.body, captured.stage)
        rows = []
        _recorded(fe, rows)
        fe.run_closed(specs, concurrency=8)
        assert fe.books()["balanced"] and fe.audit() == []
        runs[kind] = (rows, dict(fe.served_tokens))
    (g_rows, g_served), (e_rows, e_served) = runs["graph"], runs["eager"]
    assert g_served == e_served and len(g_rows) == len(e_rows) >= 4
    for (gt, gm, gl, gp), (et, em, el, ep) in zip(g_rows, e_rows):
        assert torch.equal(gt, et) and torch.equal(gm, em)
        assert all(torch.equal(a, b) for a, b in zip(gl, el))
        assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(gp, ep))


def test_spec_engine_captures_once_over_joins_kills_and_an_eviction(cuda):
    """Joins, a kill mid-span and evictions with resumes on the card, through
    the speculative step captured at construction: one capture, one compile,
    the books and every stream equal to the same run on the CPU."""
    from perceiver_io_tpu_torch import serving
    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec

    cpu, card = _twin_models()
    specs = WorkloadSpec(seed=13, prompt_lens=(24, 40), max_new_tokens=(4, 8)).draw(8, 64)
    runs = {}
    for device, model in (("cpu", cpu), ("cuda", card)):
        fe = serving.EngineFrontEnd(model, num_latents=8, device=device,
                                    injector=serving.FaultInjector().kill_at(2, 2),
                                    engine_config=serving.EngineConfig(**{**_SPEC_ENGINE, "eviction": True,
                                                                          "pool_headroom": 0.5}))
        fe.run_closed(specs, concurrency=len(specs))
        runs[device] = (fe.books(), dict(fe.served_tokens), fe.audit())
        if device == "cuda":
            assert fe._step_fn.captured.captures == 1 and fe._tracker.total_compiles == 1
    books, _, audit = runs["cuda"]
    assert runs["cuda"] == runs["cpu"] and audit == [] and books["balanced"] and books["error"] == 1
    assert books["evictions"] >= 1 and books["resumes"] == books["evictions"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spec_engine_k3_launches_per_step(cuda, dtype):
    """Each speculative step launches K3 (k + 1)(1 + depth) times: every
    drafter step over the drafter's CA pool and its depth SA pools, and
    never on the verify (the gather route); K3's build is the pools'."""
    from perceiver_io_tpu_torch import serving
    from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec
    from perceiver_io_tpu_torch.ops import build

    _, card = _twin_models(dtype)
    fe = serving.EngineFrontEnd(card, num_latents=8, device="cuda", cache_dtype=dtype,
                                engine_config=serving.EngineConfig(**_SPEC_ENGINE))
    build.reset_launches()
    fe.run_closed(WorkloadSpec(seed=5, prompt_lens=(24,), max_new_tokens=(8,)).draw(4, 64), concurrency=4)
    k3 = "paged_decode" + ("_bf16" if dtype == torch.bfloat16 else "")
    other = "paged_decode" if dtype == torch.bfloat16 else "paged_decode_bf16"
    steps = fe._engine_steps
    per_step = (_SPEC_ENGINE["spec_k"] + 1) * (1 + _SPEC_ENGINE["spec_depth"])
    assert steps >= 2 and build.LAUNCHES[k3] == steps * per_step and build.LAUNCHES[other] == 0


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_speculative_pair_graph_equals_eager(cuda, sample):
    """``make_speculative_decode_fns``' step on the card is a captured CUDA
    graph; its spans (tokens and m), lengths and generator positions equal
    the eager body's from the same prefill, and a call with another state
    raises."""
    from perceiver_io_tpu_torch import generation

    _, card = _twin_models()
    config = generation.GenerationConfig(max_new_tokens=8, do_sample=sample, temperature=0.8, top_k=20)
    ids = np.random.default_rng(4).integers(0, 64, size=(1, 40))
    prefill, step = generation.make_speculative_decode_fns(card, 8, config, k=3, draft_depth=1, device=cuda)
    assert isinstance(step.body, generation._GraphedStep)
    eager = generation._eager_step(card, config, cuda, step.body.body, step.body.stage)
    runs = {}
    for kind in ("graph", "eager"):
        generator = torch.Generator().manual_seed(7)
        token, state = prefill(ids, None, generator)
        spans = []
        for _ in range(3):
            if kind == "graph":
                state, tokens, m = step(state)
            else:
                state, tokens, m = eager(state)
                tokens, m = tokens.clone(), m.clone()
                generation.advance_span_generators(generator, m.tolist(), config)
            spans.append((tokens, m, [int(c.length) for c in state["cache"] + state["draft_cache"]],
                          generator.get_state().clone()))
        runs[kind] = spans
    for (gt, gm, gl, gg), (et, em, el, eg) in zip(runs["graph"], runs["eager"]):
        assert torch.equal(gt, et) and torch.equal(gm, em) and gl == el and torch.equal(gg, eg)
    with pytest.raises(ValueError, match="another state"):
        step(prefill(ids)[1])


def test_beam_step_graph_equals_eager(cuda, monkeypatch):
    """``beam_search`` on the card captures its step once a call; its
    sequences and scores equal the same search with the step run eagerly
    (``generation._eager_step`` in the graph's place), with left padding and
    the SA windows sliding."""
    from perceiver_io_tpu_torch import generation

    _, card = _twin_models()
    ids = np.random.default_rng(6).integers(0, 64, size=(2, 40))
    pad = np.zeros((2, 40), bool)
    pad[1, :5] = True
    kw = dict(num_latents=8, num_beams=3, max_new_tokens=12, pad_mask=pad, device=cuda)
    seqs, scores = generation.beam_search(card, ids, **kw)
    graphed = []
    real = generation._GraphedStep
    monkeypatch.setattr(generation, "_GraphedStep", lambda *a, **k: graphed.append(real(*a, **k)) or graphed[-1])
    generation.beam_search(card, ids, **kw)
    assert len(graphed) == 1 and graphed[0].captures == 1
    monkeypatch.setattr(generation, "_GraphedStep",
                        lambda model, config, name, body, stage: generation._eager_step(model, config, cuda, body,
                                                                                        stage))
    eager_seqs, eager_scores = generation.beam_search(card, ids, **kw)
    assert torch.equal(seqs, eager_seqs) and torch.equal(scores, eager_scores)


# ---------------------------------------------------------------------------
# numerics probes in the captured steps
# ---------------------------------------------------------------------------


def test_probed_graphed_train_step_keeps_copies_and_equals_the_unprobed_step(cuda):
    """The probed train step as a CUDA graph: each step's snapshot is a copy
    of the graph's outputs (two consecutive steps hold different stats, and a
    third step rewrites neither), its losses and parameters equal the
    unprobed graph's bit for bit, and its keys are the eager probed step's."""
    from perceiver_io_tpu_torch import training as tt
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.obs import probes

    def run(probe_cfg, jit=True):
        model = CausalLanguageModel(CausalLanguageModelConfig(**_GRAPH_CLM), device=cuda,
                                    generator=torch.Generator().manual_seed(0))
        state = tt.TrainState.create(model, tt.make_optimizer(1e-3, gradient_clip=1.0))
        step = tt.make_train_step(tt.clm_loss_fn(128), microbatch=2, sentinel=True, jit=jit, probes=probe_cfg)
        out = [step(state, b)[1] for b in _graph_batches(3)]
        return out, [p.detach().clone() for p in model.parameters()]

    probed, probed_params = run(probes.ProbeConfig())
    plain, plain_params = run(None)
    eager, _ = run(probes.ProbeConfig(), jit=False)
    first, second = (probes.snapshot_to_host(m["probes"]) for m in probed[1:])
    again = probes.snapshot_to_host(probed[1]["probes"])  # read after the third step's replay
    assert list(first) == list(second) == list(probes.snapshot_to_host(eager[0]["probes"]))
    assert first == again and first != second
    assert all(math.isfinite(v) for st in second.values() for v in st.values())
    for p, q in zip(probed, plain):
        assert torch.equal(p["loss"], q["loss"]) and "probes" not in q
    assert all(torch.equal(a, b) for a, b in zip(probed_params, plain_params))


def test_probed_decode_pair_equals_the_unprobed_pair(cuda):
    """``make_decode_fns(probes=True)`` on the card: the same stream as the
    pair without probes token for token, each token's ``kv_cache_frac`` the
    host's ``(length - start) / capacity``, the gauges copies per token, and
    the graph's other kernel nodes the unprobed graph's."""
    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**_DECODE_CLM), device=cuda,
                                generator=torch.Generator().manual_seed(0))
    config = generation.GenerationConfig(max_new_tokens=21)
    ids = np.random.default_rng(4).integers(0, 262, size=(1, 64))
    runs = {}
    for probes in (False, True):
        prefill, step = generation.make_decode_fns(model, 16, config, probes=probes, device=cuda)
        token, state = prefill(ids)
        tokens, healths = [token.clone()], []
        for _ in range(20):
            if probes:
                healths.append({k: v.clone() for k, v in state["probe"].items()})
            state, token = step(state)
            tokens.append(token)
        runs[probes] = (torch.stack(tokens, 1), healths, step.body.graph)
    assert torch.equal(runs[True][0], runs[False][0])
    capacity = 64 + 21
    for i, h in enumerate(runs[True][1]):
        length, start = 64 + i, max(0, 64 + i - _DECODE_CLM["max_seq_len"])
        assert float(h["kv_cache_frac"]) == float(np.float32(length - start) / np.float32(capacity))
        assert float(h["nonfinite_logit_frac"]) == 0.0 and math.isfinite(float(h["logit_entropy"]))
    names = ["_layer_norm_fwd_kernel", "flash_packed_kernel", "paged_walk_kernel"]
    assert runs[True][2].kernel_nodes(names) != {} and {k: v for k, v in runs[True][2].kernel_nodes(names).items()
                                                        if k != "kernel nodes"} == \
        {k: v for k, v in runs[False][2].kernel_nodes(names).items() if k != "kernel nodes"}


# ---------------------------------------------------------------------------
# the Perceiver IO task models' geometries (ROADMAP A13, part 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,dqk,dv,nq,nkv", [
    (4, 32, 160, 64, 300),    # the masked LM encoder's heads (q/k 32, v 160), cross-attention
    (4, 32, 160, 64, 64),     # and self-attention
    (1, 322, 322, 100, 1500),  # optical flow's encoder head (the wrapper pads 322 to 328)
    (1, 512, 512, 1500, 100),  # its decoder: many more queries than latents
    (1, 256, 256, 90, 300),   # the time series' heads
])
def test_flash_heads_kernels_at_the_task_models_heads(cuda, dtype, h, dqk, dv, nq, nkv):
    """K8 and K9a/K9b (through the autograd Function) at the head dims of the
    masked LM, optical flow and the time series, non-causal, against the
    plain heads-major versions: f32 out atol 1e-5, gradients against the f64
    plain backward atol 1e-5 (dQ 6e-5, as ``chip_smoke.py``); bf16 within one
    bf16 step of the plain bf16 version's output (2e-2 of its largest
    magnitude, ``chip_smoke.check_bf16``'s element rule)."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    g = torch.Generator().manual_seed(21)
    q = (torch.randn(2, h, nq, dqk, generator=g) * dqk**-0.5).to(cuda, dtype).requires_grad_()
    k = torch.randn(2, h, nkv, dqk, generator=g).to(cuda, dtype).requires_grad_()
    v = torch.randn(2, h, nkv, dv, generator=g).to(cuda, dtype).requires_grad_()
    do = torch.randn(2, h, nq, dv, generator=g).to(cuda, dtype)
    build.reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True)
    o.backward(do)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    assert [build.LAUNCHES[n + sfx] for n in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] == \
        [1, 1, 1]
    plain = [t.detach() for t in (q, k, v)]
    ro, _ = flash_attention_reference(*plain)
    if dtype == torch.bfloat16:
        rel = 2e-2 * float(ro.float().abs().max())
        torch.testing.assert_close(o.detach().float(), ro.float(), atol=rel, rtol=0)
        return
    torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
    want = flash_attention_bwd_reference(*(t.double() for t in (*plain, o.detach(), lse, do)))
    for got, w, tol in zip((q.grad, k.grad, v.grad), want, (6e-5, 1e-5, 1e-5)):
        torch.testing.assert_close(got.double(), w, atol=tol, rtol=0)


@pytest.mark.parametrize("nq,nkv,dv,batch", [(300, 64, 96, 2), (1, 256, 32, 3)], ids=["mlm", "text_clf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_packed_kernels_at_the_masked_lm_decoder(cuda, dtype, nq, nkv, dv, batch):
    """K2 and K4a/K4b at the task models' decoder cross-attentions,
    non-causal, 8 heads of q/k 32: the masked LM's cut to size (300 queries
    over 64 latents, v 96; right-padded rows as the batch gives them, no key
    mask) and the text classifier's (one query over 256 latents, v 32); f32
    against the plain versions atol 1e-5, bf16 within 2e-2 of the plain
    bf16 output's and gradients' largest magnitudes."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
        flash_attention_packed_reference,
    )

    g = torch.Generator().manual_seed(22)
    h = 8
    q = (torch.randn(batch, nq, h * 32, generator=g) * 32**-0.5).to(cuda, dtype).requires_grad_()
    k = torch.randn(batch, nkv, h * 32, generator=g).to(cuda, dtype).requires_grad_()
    v = torch.randn(batch, nkv, h * dv, generator=g).to(cuda, dtype).requires_grad_()
    do = torch.randn(batch, nq, h * dv, generator=g).to(cuda, dtype)
    build.reset_launches()
    o, lse = flash_attention_packed(q, k, v, h, return_lse=True)
    o.backward(do)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    assert [build.LAUNCHES[n + sfx] for n in ("flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq")] \
        == [1, 1, 1]
    ro, _ = flash_attention_packed_reference(q.detach(), k.detach(), v.detach(), h)
    want = flash_attention_packed_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(), lse, do, h)
    for got, w in zip((o.detach(), q.grad, k.grad, v.grad), (ro, *want)):
        atol = 2e-2 * float(w.float().abs().max()) if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("c", [768, 1280, 322, 256])
def test_layer_norm_kernels_at_the_task_models_widths(cuda, c):
    """K1 with statistics and K5 at the masked LM's widths (768, 1280),
    optical flow's (322, no multiple of 8) and the time series' (256),
    against the plain versions: y
    atol 1e-5, dx 4e-6, dgamma/dbeta 4e-4 (as the tests above)."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd_reference, layer_norm_reference

    g = torch.Generator().manual_seed(23)
    x = (torch.randn(999, c, generator=g) * 3 + 1).to(cuda).requires_grad_()
    w, b = (torch.randn(c, generator=g).to(cuda).requires_grad_() for _ in range(2))
    dy = torch.randn(999, c, generator=g).to(cuda)
    build.reset_launches()
    y = layer_norm(x, w, b)
    y.backward(dy)
    assert build.LAUNCHES["layer_norm_fwd"] == 1 and build.LAUNCHES["layer_norm_bwd"] == 1
    torch.testing.assert_close(y.detach(), layer_norm_reference(x.detach(), w.detach(), b.detach()), atol=1e-5, rtol=0)
    xd = x.detach()
    mean = xd.mean(dim=-1)
    rstd = torch.rsqrt(torch.clamp((xd * xd).mean(dim=-1) - mean * mean, min=0.0) + 1e-5)
    dx, dw, db = layer_norm_bwd_reference(xd, w.detach(), mean, rstd, dy)
    torch.testing.assert_close(x.grad, dx, atol=4e-6, rtol=0)
    torch.testing.assert_close(w.grad, dw, atol=4e-4, rtol=0)
    torch.testing.assert_close(b.grad, db, atol=4e-4, rtol=0)


def _task_models():
    """Micro masked LM (tied), optical flow and time series, with their
    inputs, at the heads of ``tests/test_torch_mlm.py``,
    ``test_torch_optical_flow.py`` and ``test_torch_timeseries.py``."""
    from perceiver_io_tpu_torch.models.text import MaskedLanguageModelConfig, TextDecoderConfig, TextEncoderConfig
    from perceiver_io_tpu_torch.models.timeseries import (
        TimeSeriesDecoderConfig,
        TimeSeriesEncoderConfig,
        TimeSeriesPerceiverConfig,
    )
    from perceiver_io_tpu_torch.models.vision import OpticalFlowConfig, OpticalFlowDecoderConfig
    from perceiver_io_tpu_torch.models.vision import OpticalFlowEncoderConfig

    rng = np.random.default_rng(24)
    mlm = MaskedLanguageModelConfig(
        encoder=TextEncoderConfig(vocab_size=262, max_seq_len=200, num_input_channels=48, num_cross_attention_heads=2,
                                  num_cross_attention_qk_channels=16, num_cross_attention_v_channels=40,
                                  num_self_attention_heads=2, num_self_attention_qk_channels=16,
                                  num_self_attention_v_channels=40, num_self_attention_layers_per_block=2),
        decoder=TextDecoderConfig(vocab_size=262, max_seq_len=200, num_cross_attention_heads=2,
                                  num_cross_attention_qk_channels=16, num_cross_attention_v_channels=48,
                                  cross_attention_residual=False),
        num_latents=64, num_latent_channels=32)
    flow = OpticalFlowConfig(
        encoder=OpticalFlowEncoderConfig(image_shape=(24, 32), num_patch_hidden_channels=13, num_frequency_bands=4,
                                         num_cross_attention_heads=1, num_self_attention_heads=2,
                                         num_self_attention_layers_per_block=2),
        decoder=OpticalFlowDecoderConfig(image_shape=(24, 32), num_cross_attention_heads=1,
                                         num_cross_attention_qk_channels=36, num_cross_attention_v_channels=36,
                                         cross_attention_residual=False),
        num_latents=64, num_latent_channels=32)
    ts = TimeSeriesPerceiverConfig(
        encoder=TimeSeriesEncoderConfig(num_input_channels=3, in_len=300, num_frequency_bands=4,
                                        num_cross_attention_heads=1, num_self_attention_heads=1,
                                        num_self_attention_layers_per_block=1, num_self_attention_blocks=2),
        decoder=TimeSeriesDecoderConfig(out_len=200, num_output_channels=3, num_cross_attention_heads=1),
        num_latents=64, num_latent_channels=20)
    ids = rng.integers(0, 262, size=(2, 180))
    pad = np.zeros((2, 180), bool)
    pad[1, 150:] = True
    return {"mlm": (mlm, (torch.from_numpy(ids),), {"pad_mask": torch.from_numpy(pad)}),
            "flow": (flow, (torch.from_numpy(rng.normal(size=(2, 2, 24, 32, 27)).astype(np.float32)),), {}),
            "timeseries": (ts, (torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32)),), {})}


@pytest.mark.parametrize("name", ["mlm", "flow", "timeseries"])
def test_task_models_on_the_card_match_the_cpu(cuda, name):
    """Each task model's forward on the card (K8 in every one; K2 in the
    masked LM's decoder and optical flow's self-attention; K1 throughout)
    against the same weights on the CPU (plain versions), atol 1e-4 relative
    to the output's largest magnitude."""
    from perceiver_io_tpu_torch.models.text import MaskedLanguageModel
    from perceiver_io_tpu_torch.models.timeseries import TimeSeriesPerceiver
    from perceiver_io_tpu_torch.models.vision import OpticalFlow
    from perceiver_io_tpu_torch.ops import build

    config, args, kwargs = _task_models()[name]
    cls = {"mlm": MaskedLanguageModel, "flow": OpticalFlow, "timeseries": TimeSeriesPerceiver}[name]
    out = {}
    for dev in ("cpu", cuda):
        model = cls(config, device=dev, generator=torch.Generator().manual_seed(0))
        build.reset_launches()
        with torch.no_grad():
            out[str(dev)] = model(*(a.to(dev) for a in args), **{k: v.to(dev) for k, v in kwargs.items()}).cpu()
    assert build.LAUNCHES["flash_heads_fwd"] >= 1 and build.LAUNCHES["layer_norm_fwd"] >= 1
    if name != "timeseries":
        assert build.LAUNCHES["flash_packed_fwd"] >= 1
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4 * scale, rtol=0)


def test_mask_filler_on_the_card_matches_the_cpu(cuda):
    """``MaskFiller`` on the card gives the CPU filler's strings (top-1 fills
    of a micro masked LM from the same weights)."""
    from perceiver_io_tpu_torch.data.text.tokenizer import ByteTokenizer
    from perceiver_io_tpu_torch.hf import MaskFiller
    from perceiver_io_tpu_torch.models.text import MaskedLanguageModel

    config = _task_models()["mlm"][0]
    samples = ["The [MASK] sat on the mat.", "[MASK] and [MASK]"]
    fills = [MaskFiller(MaskedLanguageModel(config, device=dev, generator=torch.Generator().manual_seed(1)),
                        ByteTokenizer(), device=dev).fill(samples, num_predictions=1) for dev in ("cpu", cuda)]
    assert fills[0] == fills[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [
    (True, 130, 300, 7),    # the SAM's causal cross-attention: latents right-aligned over more keys
    (True, 200, 200, 0),    # its causal latent self-attention
    (True, 64, 2100, 0),    # a long kv walk (split in the forward)
])
def test_flash_packed_kernels_at_heads_of_96(cuda, dtype, causal, nq, nkv, n_pad):
    """K2 and K4a/K4b at the symbolic audio model's heads of 96 (the 128
    tile, 8 heads), causal, through the autograd Function: f32 against the
    plain forward (atol 1e-5) and the plain backward in f64 (atol 1e-5);
    bf16 by the card's bf16 rule, one launch each of the dtype's build."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
        flash_attention_packed_reference,
    )

    g = torch.Generator().manual_seed(23)
    h, d = 8, 96
    q, k, v = (torch.randn(2, n, h * d, generator=g).to(cuda, dtype).requires_grad_() for n in (nq, nkv, nkv))
    do = torch.randn(2, nq, h * d, generator=g).to(cuda, dtype)
    pad = torch.zeros(2, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    kw = dict(pad_mask=pad, causal=causal, sm_scale=d**-0.5)
    build.reset_launches()
    o, lse = flash_attention_packed(q, k, v, h, return_lse=True, **kw)
    o.backward(do)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    assert [build.LAUNCHES[n + sfx] for n in ("flash_packed_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq")] \
        == [1, 1, 1]
    ops = [t.detach() for t in (q, k, v)]
    ro, rlse = flash_attention_packed_reference(*ops, h, **kw)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    f64 = flash_attention_packed_bwd_reference(*(t.double() for t in (*ops, o.detach(), lse, do)), h, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
        for got, w in zip((q.grad, k.grad, v.grad), f64):
            torch.testing.assert_close(got.double(), w, atol=1e-5, rtol=0)
        return
    eo, _ = flash_attention_packed_reference(*(t.double() for t in ops), h, **kw)
    _bf16_rule(o.detach(), ro, eo, 1.25)
    plain = flash_attention_packed_bwd_reference(*ops, o.detach(), lse, do, h, **kw)
    for got, p, e in zip((q.grad, k.grad, v.grad), plain, f64):
        _bf16_rule(got, p, e, 1.25)


@pytest.mark.parametrize("b,nq,nkv", [(64, 32, 784), (3, 32, 100)])
def test_flash_heads_kernels_at_mnists_head_of_131(cuda, b, nq, nkv):
    """K8 and K9a/K9b at MNIST's cross-attention (one head of 131 input
    channels, which the wrapper pads to 136; 32 latents over 784 pixels,
    non-causal) against the plain forward (atol 1e-5) and the plain backward
    in f64 (atol 1e-5)."""
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    g = torch.Generator().manual_seed(24)
    d = 131
    q, k, v = (torch.randn(b, 1, n, d, generator=g).to(cuda).requires_grad_() for n in (nq, nkv, nkv))
    do = torch.randn(b, 1, nq, d, generator=g).to(cuda)
    build.reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True, sm_scale=d**-0.5)
    o.backward(do)
    assert [build.LAUNCHES[n] for n in ("flash_heads_fwd", "flash_heads_bwd_dkv", "flash_heads_bwd_dq")] == [1, 1, 1]
    plain = [t.detach() for t in (q, k, v)]
    ro, _ = flash_attention_reference(*plain, sm_scale=d**-0.5)
    torch.testing.assert_close(o.detach(), ro, atol=1e-5, rtol=0)
    want = flash_attention_bwd_reference(*(t.double() for t in (*plain, o.detach(), lse, do)), sm_scale=d**-0.5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got.double(), w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [6000, 4097])
def test_layer_norm_kernels_at_c_768(cuda, dtype, rows):
    """K1 (with statistics) and K5 at the symbolic audio model's C 768
    (the prefill's 6000 prompt rows, a ragged row count) against the plain
    versions: f32 y, dx atol 2e-6 and dgamma/dbeta 5e-4 (chip_smoke.py's);
    bf16 by the card's bf16 rule against the f64 evaluation."""
    from perceiver_io_tpu_torch.ops.layernorm import (
        layer_norm_bwd_cuda,
        layer_norm_bwd_reference,
        layer_norm_cuda,
        layer_norm_reference_stats,
    )

    g = torch.Generator().manual_seed(25)
    c = 768
    x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to(cuda, dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    b = (0.1 * torch.randn(c, generator=g)).to(cuda)
    dy = torch.randn(rows, c, generator=g).to(cuda, dtype)
    y, mean, rstd = layer_norm_cuda(x, w, b, 1e-5, dtype, want_stats=True)
    ry, rmean, rrstd = layer_norm_reference_stats(x, w, b, 1e-5, dtype)
    got = layer_norm_bwd_cuda(x, w, mean, rstd, dy)
    plain = layer_norm_bwd_reference(x, w, mean, rstd, dy)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ry, atol=2e-6, rtol=0)
        torch.testing.assert_close(got[0], plain[0], atol=2e-6, rtol=0)
    else:
        e = layer_norm_reference_stats(x.double(), w.double(), b.double(), 1e-5, torch.float64)[0]
        _bf16_rule(y, ry, e, 1.25)
        ed = layer_norm_bwd_reference(x.double(), w.double(), mean.double(), rstd.double(), dy.double())
        _bf16_rule(got[0], plain[0], ed[0], 1.25)
    for gw, pw in zip(got[1:], plain[1:]):
        torch.testing.assert_close(gw, pw, atol=5e-4, rtol=0)


def test_symbolic_audio_pipeline_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``pipeline("symbolic-audio-generation", model_dir=...)`` of a micro SAM
    on the card gives the CPU pipeline's greedy (``top_k=1``) ids from the
    same ``save_pretrained`` directory, and its one-seed sampled ids twice;
    the prefill launches K2 and K1, the decode step replays a graph."""
    from perceiver_io_tpu_torch.data.audio import midi
    from perceiver_io_tpu_torch.hf import pipeline
    from perceiver_io_tpu_torch.models.audio import SymbolicAudioModel, SymbolicAudioModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.training import save_pretrained

    config = SymbolicAudioModelConfig(max_seq_len=256, max_latents=64, num_channels=192, num_heads=2,
                                      num_self_attention_layers=2)
    save_pretrained(str(tmp_path), SymbolicAudioModel(config, device="cpu"), config)
    prompt = midi.encode_notes([midi.Note(70, 40 + i % 30, 0.1 * i, 0.1 * i + 0.3) for i in range(120)])[:220]
    assert len(prompt) == 220  # 28 latents: the prefill's spans take K2
    ids = {}
    for dev in ("cpu", "cuda"):
        build.reset_launches()
        ids[dev] = pipeline("symbolic-audio-generation", model_dir=str(tmp_path), device=dev)(
            prompt, max_new_tokens=48, top_k=1).token_ids
    assert build.LAUNCHES["flash_packed_fwd"] == 3 and build.LAUNCHES["layer_norm_fwd"] >= 1
    np.testing.assert_array_equal(ids["cuda"], ids["cpu"])
    pipe = pipeline("symbolic-audio-generation", model_dir=str(tmp_path))
    np.testing.assert_array_equal(pipe(prompt, max_new_tokens=48, seed=5).token_ids,
                                  pipe(prompt, max_new_tokens=48, seed=5).token_ids)


def test_tensor_norms_do_not_depend_on_where_a_tensor_starts(cuda):
    """The clip's and LAMB's norms (``optim.tensor_norms``) of f32 views that
    start off a 16-byte boundary, as FSDP2 leaves a parameter's block in its
    flat buffer, equal the norms of the same values in their own allocation,
    bit for bit: torch's foreach norm sums the two layouts in other orders
    (without the aligned copy the f32 norms came out apart on an H100)."""
    from perceiver_io_tpu_torch.training.optim import tensor_norms

    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(1024, 264), (4096, 33), (7,), (512, 1024)]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(2 + sum(sizes), device=cuda, generator=g)
    views, offset = [], 2
    for shape, n in zip(shapes, sizes):
        views.append(flat[offset:offset + n].view(shape))
        offset += n
    whole = [v.clone() for v in views]
    assert all(v.data_ptr() % 16 for v in views) and not any(w.data_ptr() % 16 for w in whole)
    assert torch.equal(tensor_norms(views), tensor_norms(whole))
