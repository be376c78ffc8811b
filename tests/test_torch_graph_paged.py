"""The engine's fixed state (the form a CUDA graph of its decode step needs),
on the CPU against the JAX package.

Joins and retires write into the engine's state tensors in place
(``core.cache.commit_prefill_``/``release_slot_``), and the paged step's
body writes the next state into the tensors it read, so every tensor of the
state keeps its address through a serve. With the draws staged by the host
before each step, every served stream still equals the port's sequential
``make_decode_fns`` stream (greedy, temperature + top-k, top-p: one uniform
per emitted token from the request's generator), and the greedy streams
equal the JAX engine's, token for token, from the same parameters. Pages
of 4 rows keep the JAX engine on its gather route (its paged kernel takes
pages of at least 8), which runs fast on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.generation import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.loadgen import RequestSpec as JaxRequestSpec
from perceiver_io_tpu.serving import EngineConfig as JaxEngineConfig
from perceiver_io_tpu.serving import EngineFrontEnd as JaxEngineFrontEnd
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache, release_slot, release_slot_
from perceiver_io_tpu_torch.generation import GenerationConfig, _state_tensors, make_decode_fns
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

VOCAB, NUM_LATENTS = 64, 4
# max_seq_len 16 < prompt + budget and max_latents 8 < latents + budget:
# both windows slide in the longer requests
CONFIG = dict(vocab_size=VOCAB, max_seq_len=16, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2)
ENGINE = dict(slots=3, page_size=4, max_ca_tokens=24, max_sa_tokens=16)


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _specs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt_len = int(rng.choice([8, 12]))
        out.append(dict(index=i, prompt_len=prompt_len, max_new_tokens=int(rng.integers(4, 10)),
                        input_ids=rng.integers(0, VOCAB, size=(1, prompt_len)), rng_seed=int(rng.integers(1 << 20))))
    return out


def _sequential(model, spec, base_config):
    cfg = dataclasses.replace(base_config, max_new_tokens=spec["max_new_tokens"])
    prefill, step = make_decode_fns(model, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec["input_ids"], None, torch.Generator().manual_seed(spec["rng_seed"]))
    out = [int(token[0])]
    for _ in range(spec["max_new_tokens"] - 1):
        state, token = step(state)
        out.append(int(token[0]))
    return out


@pytest.mark.parametrize(
    "base_config",
    [GenerationConfig(), GenerationConfig(do_sample=True, temperature=0.8, top_k=10),
     GenerationConfig(do_sample=True, top_p=0.9)],
    ids=["greedy", "temperature_top_k", "top_p"],
)
def test_fixed_state_engine_streams_equal_sequential(models, base_config):
    _, _, tm = models
    specs = _specs(7, seed=21)
    engine = EngineFrontEnd(tm, num_latents=NUM_LATENTS, base_config=base_config, device="cpu",
                            engine_config=EngineConfig(**ENGINE))
    addresses = _state_tensors(engine._state)
    records = engine.run_closed([RequestSpec(**s) for s in specs], concurrency=5)
    assert [r.outcome for r in records] == ["ok"] * len(specs)
    assert _state_tensors(engine._state) == addresses
    for spec in specs:
        assert engine.served_tokens[spec["index"]] == _sequential(tm, spec, base_config), spec["index"]
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0


def test_fixed_state_engine_greedy_streams_equal_jax_engine(models):
    jm, params, tm = models
    specs = _specs(5, seed=22)
    engine = EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu", engine_config=EngineConfig(**ENGINE))
    engine.run_closed([RequestSpec(**s) for s in specs], concurrency=4)
    jfe = JaxEngineFrontEnd(jm, params, num_latents=NUM_LATENTS, base_config=JaxGenerationConfig(),
                            engine_config=JaxEngineConfig(**ENGINE))
    jrecords = jfe.run_closed([JaxRequestSpec(**s) for s in specs], concurrency=4)
    assert [r.outcome for r in jrecords] == ["ok"] * len(specs)
    for spec in specs:
        assert engine.served_tokens[spec["index"]] == [int(t) for t in jfe.served_tokens[spec["index"]]]


def test_release_forms_agree_and_only_the_in_place_one_mutates():
    cache = init_paged_kv_cache(2, 5, 4, 2, 8, 8, device="cpu")
    cache.page_table[:] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cache.length[:] = torch.tensor([7, 5], dtype=torch.int32)
    released = release_slot(cache, 1)
    assert cache.length.tolist() == [7, 5] and cache.page_table[1].tolist() == [3, 4]
    table, length = cache.page_table, cache.length
    release_slot_(cache, 1)
    assert cache.page_table is table and cache.length is length
    assert torch.equal(cache.page_table, released.page_table) and torch.equal(cache.length, released.length)
    assert cache.length.tolist() == [7, 0] and cache.page_table.tolist() == [[1, 2], [0, 0]]
