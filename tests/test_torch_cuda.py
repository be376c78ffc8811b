"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA card, at small shapes: K2 (packed flash forward), K3 (paged
decode), K1 (LayerNorm forward), and the engine serving through them. Marked
``cuda``; each test skips on a machine without a card. Run them on one with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
suite's conftest imports JAX, which the port does not need). Tolerances: f32
atol 1e-5; bf16 outputs within one bf16 step."""

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
@pytest.mark.parametrize("causal,nq,nkv,n_pad", [(True, 37, 203, 5), (False, 64, 64, 0), (True, 130, 130, 0)])
def test_flash_packed_kernel_matches_plain(cuda, dtype, causal, nq, nkv, n_pad):
    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_reference,
    )

    g = torch.Generator().manual_seed(0)
    h, d = 4, 64
    q, k, v = (torch.randn(2, n, h * d, generator=g).to(cuda, dtype) for n in (nq, nkv, nkv))
    pad = torch.zeros(2, nkv, dtype=torch.bool, device=cuda)
    pad[1, :n_pad] = True
    o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=d**-0.5, return_lse=True)
    ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=causal, sm_scale=d**-0.5)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2**-7)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_paged_decode_kernel_matches_plain(cuda, with_mask):
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    g = torch.Generator().manual_seed(1)
    slots, page, pps, h, d = 5, 16, 8, 8, 64
    cache = init_paged_kv_cache(slots, 1 + slots * pps, page, pps, h * d, h * d, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    cache.page_table = (torch.randperm(slots * pps, generator=g) + 1).reshape(slots, pps).to(cuda, torch.int32)
    cache.length = torch.tensor([1, 16, 17, 100, 128], dtype=torch.int32, device=cuda)
    qh = torch.randn(slots, h, d, generator=g).to(cuda) * d**-0.5
    mask = None
    if with_mask:  # left pads / expired window slots; every slot keeps a real key
        mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device=cuda)
        mask[2, :5] = True
        mask[4, :100] = True
    torch.testing.assert_close(paged_decode_attention(qh, cache, mask), paged_attention_reference(qh, cache, mask),
                               atol=1e-5, rtol=0)


def test_unported_head_dims_raise_on_the_card(cuda):
    """Head dims the packed kernel cannot take need the heads-major kernel,
    which is not ported: the cache-free route refuses them on the card."""
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention

    mha = MultiHeadAttention(2, 24, 24, causal_attention=True).to(cuda)  # head dim 12
    x = torch.randn(1, 5, 24, device=cuda)
    with pytest.raises(NotImplementedError, match="heads-major"):
        mha(x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda, dtype):
    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_reference

    g = torch.Generator().manual_seed(2)
    x = (torch.randn(1000, 512, generator=g) * 3 + 1).to(cuda, dtype)
    w, b = (torch.randn(512, generator=g).to(cuda) for _ in range(2))
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2**-7)
    torch.testing.assert_close(layer_norm(x, w, b).float(), layer_norm_reference(x, w, b).float(), **tol)


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
    assert all(n > 0 for n in build.LAUNCHES.values()), build.LAUNCHES
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0
    for spec in specs:
        prefill, step = make_decode_fns(model, 8, GenerationConfig(max_new_tokens=6), device=cuda)
        token, state = prefill(spec.input_ids)
        want = [int(token[0])]
        for _ in range(5):
            state, token = step(state)
            want.append(int(token[0]))
        assert engine.served_tokens[spec.index] == want
