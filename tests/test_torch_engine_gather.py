"""The paged decode's route at wide heads and int8 pools.

The engine at head dim 160 (320 channels in 2 heads, which the JAX
package's own paged kernel refuses) on the CPU: K3 takes heads up to 512, so
its wrapper runs its plain version there (one gather per pool, then dense
attention), and the served stream equals the port's sequential
``make_decode_fns`` stream and the JAX engine's stream, token for token
(greedy, from the same parameters). The port's copy of the JAX kernel's gate
agrees with the JAX function, on float and int8 pools (JAX keeps int8 off its
kernel, and so does K3's gate); on the CPU the gather route serves the
geometries only the JAX kernel takes (the card refuses those,
tests/test_torch_cuda.py): heads wider than 512, in f32 or bf16 pools."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.core.cache import init_paged_kv_cache as jax_init_paged_kv_cache
from perceiver_io_tpu.generation import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.loadgen import RequestSpec as JaxRequestSpec
from perceiver_io_tpu.ops.paged_attention import paged_kernel_supported as jax_paged_kernel_supported
from perceiver_io_tpu.serving import EngineConfig as JaxEngineConfig
from perceiver_io_tpu.serving import EngineFrontEnd as JaxEngineFrontEnd
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
from perceiver_io_tpu_torch.generation import GenerationConfig, make_decode_fns
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_kernel_supported,
    reference_kernel_geometry,
)
from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

VOCAB, NUM_LATENTS = 64, 4
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=320, num_heads=2,
              num_self_attention_layers=2)
ENGINE = dict(slots=2, page_size=8, max_ca_tokens=24, max_sa_tokens=16)


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _spec():
    ids = np.random.default_rng(1).integers(0, VOCAB, size=(1, 8))
    return dict(index=0, prompt_len=8, max_new_tokens=4, input_ids=ids, rng_seed=0)


def test_head_dim_160_engine_serves_by_the_gather_route(models):
    jm, params, tm = models
    spec = _spec()
    engine = EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu", engine_config=EngineConfig(**ENGINE))
    h, d = CONFIG["num_heads"], CONFIG["num_channels"] // CONFIG["num_heads"]
    assert all(paged_kernel_supported(pool, h, d, d) for pool in engine._state["cache"])
    records = engine.run_closed([RequestSpec(**spec)], concurrency=1)
    assert [r.outcome for r in records] == ["ok"]
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0
    got = engine.served_tokens[0]
    assert len(got) == 4

    prefill, step = make_decode_fns(tm, NUM_LATENTS, GenerationConfig(max_new_tokens=4), device="cpu")
    token, state = prefill(spec["input_ids"])
    sequential = [int(token[0])]
    for _ in range(3):
        state, token = step(state)
        sequential.append(int(token[0]))
    assert got == sequential

    jfe = JaxEngineFrontEnd(jm, params, num_latents=NUM_LATENTS, base_config=JaxGenerationConfig(),
                            engine_config=JaxEngineConfig(**ENGINE))
    jrecords = jfe.run_closed([JaxRequestSpec(**spec)], concurrency=1)
    assert [r.outcome for r in jrecords] == ["ok"]
    assert got == [int(t) for t in jfe.served_tokens[0]]


@pytest.mark.parametrize("heads,d,page_size,dtype", [
    (2, 160, 8, "float32"),   # 320 channels: the JAX kernel refuses, K3 serves
    (2, 192, 8, "float32"),   # 384: both kernels (K3 takes heads up to 512)
    (2, 192, 8, "bfloat16"),  # 384 in bf16: both kernels
    (8, 64, 8, "float32"),    # the flagship's heads: both kernels
    (2, 64, 4, "float32"),    # pages below 8 rows: the JAX kernel refuses
    (3, 40, 8, "float32"),    # 120 channels
    (4, 32, 16, "float32"),
    (8, 64, 8, "int8"),       # int8 pools: both packages gather
    (2, 192, 16, "int8"),
    (2, 640, 8, "float32"),   # 1280: the JAX kernel serves, K3 (heads up to 512) does not
])
def test_the_route_gate_copies_the_jax_kernels_gate(heads, d, page_size, dtype):
    c = heads * d
    jcache = jax_init_paged_kv_cache(2, 3, page_size, 1, c, c, dtype=getattr(jnp, dtype))
    tcache = init_paged_kv_cache(2, 3, page_size, 1, c, c, dtype=getattr(torch, dtype), device="cpu")
    assert reference_kernel_geometry(tcache, heads, d, d) == jax_paged_kernel_supported(jcache, heads, d, d)


@pytest.mark.parametrize("heads,d,dtype,served", [
    (8, 64, torch.float32, True),
    (2, 160, torch.float32, True),    # wide heads, up to 512, in both builds
    (2, 256, torch.bfloat16, True),
    (1, 512, torch.float32, True),
    (1, 513, torch.float32, False),
    (2, 640, torch.bfloat16, False),
    (8, 64, torch.int8, False),       # int8 pools take the gather route
    (2, 192, torch.int8, False),
])
def test_k3s_gate_takes_heads_up_to_512_and_no_int8_pool(heads, d, dtype, served):
    c = heads * d
    tcache = init_paged_kv_cache(2, 3, 8, 1, c, c, dtype=dtype, device="cpu")
    assert paged_kernel_supported(tcache, heads, d, d) == served


@pytest.mark.parametrize("heads,d,dtype", [(2, 640, torch.float32), (2, 640, torch.bfloat16)])
def test_cpu_gathers_where_only_the_jax_kernel_serves(heads, d, dtype):
    """On the CPU the gather route serves pools K3 cannot take (heads of 640,
    over K3's 512), and gives K3's plain version over the same pools,
    projected."""
    c, slots, page = heads * d, 2, 8
    torch.manual_seed(0)
    layer = MultiHeadAttention(heads, c, c, causal_attention=True).to(dtype)
    cache = init_paged_kv_cache(slots, 5, page, 2, c, c, dtype=dtype, device="cpu")
    cache.k.normal_()
    cache.v.normal_()
    cache.page_table[:] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cache.length[:] = torch.tensor([11, 5], dtype=torch.int32)
    assert not paged_kernel_supported(cache, heads, d, d) and reference_kernel_geometry(cache, heads, d, d)
    x = torch.randn(slots, 1, c).to(dtype)
    with torch.no_grad():
        out = layer(x, x, kv_cache=cache)
        appended = out.kv_cache
        qh = layer.project_q(x)[:, :, 0, :]
        want = layer.o_proj(paged_attention_reference(qh, appended).reshape(slots, 1, c).to(dtype))
    assert appended.length.tolist() == [12, 6]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.last_hidden_state.float(), want.float(), **tol)
