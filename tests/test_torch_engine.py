"""The port's continuous-batching engine on the CPU (the plain kernel
versions): every served stream equals the port's sequential
``make_decode_fns`` stream for the same prompt and seed, token for token,
greedy and sampled, with both windows sliding; the page allocators end
empty; a request that can never fit sheds ``kv_pages_exhausted`` at
admission; the entry points run on ``cuda`` unless asked for the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from perceiver_io_tpu_torch.generation import GenerationConfig, generate, make_decode_fns, make_paged_step_fn
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

VOCAB, NUM_LATENTS = 64, 4
# max_seq_len 16 < prompt + budget and max_latents 8 < latents + budget:
# both windows slide in the longer requests
CONFIG = dict(vocab_size=VOCAB, max_seq_len=16, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, init_scale=0.2)


@pytest.fixture(scope="module")
def model():
    return CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu",
                               generator=torch.Generator().manual_seed(0))


def _engine(model, base_config, slots=4):
    return EngineFrontEnd(model, num_latents=NUM_LATENTS, base_config=base_config, device="cpu",
                          engine_config=EngineConfig(slots=slots, page_size=8, max_ca_tokens=24,
                                                     max_sa_tokens=16))


def _specs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt_len = int(rng.choice([8, 12]))
        out.append(RequestSpec(index=i, prompt_len=prompt_len, max_new_tokens=int(rng.integers(4, 10)),
                               input_ids=rng.integers(0, VOCAB, size=(1, prompt_len)),
                               rng_seed=int(rng.integers(1 << 20))))
    return out


def _sequential(model, spec, base_config):
    cfg = dataclasses.replace(base_config, max_new_tokens=spec.max_new_tokens)
    prefill, step = make_decode_fns(model, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec.input_ids, None, torch.Generator().manual_seed(spec.rng_seed))
    out = [int(token[0])]
    for _ in range(spec.max_new_tokens - 1):
        state, token = step(state)
        out.append(int(token[0]))
    return out


@pytest.mark.parametrize(
    "base_config",
    [GenerationConfig(), GenerationConfig(do_sample=True, temperature=0.8, top_k=10),
     GenerationConfig(do_sample=True, top_p=0.9)],
    ids=["greedy", "temperature_top_k", "top_p"],
)
def test_engine_streams_equal_sequential(model, base_config):
    specs = _specs(8, seed=13)
    engine = _engine(model, base_config)
    records = engine.run_closed(specs, concurrency=8)
    assert [r.outcome for r in records] == ["ok"] * 8
    assert engine.books()["balanced"] and engine.books()["ok"] == 8
    for spec in specs:
        assert engine.served_tokens[spec.index] == _sequential(model, spec, base_config), spec.index
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0
    assert engine.ca_alloc.audit() == [] and engine.sa_alloc.audit() == []
    assert 0.5 < engine.mean_batch_fill <= 1.0


def test_engine_eos_retires_early(model):
    specs = _specs(4, seed=5)
    want = {s.index: _sequential(model, s, GenerationConfig()) for s in specs}
    # an eos id that first fires mid-stream for request 0
    eos = next(t for t in want[0][1:] if t != want[0][0])
    engine = _engine(model, GenerationConfig(eos_token_id=eos))
    for spec in specs:
        engine.submit(spec)
    engine.pump()
    books = engine.books()
    assert {k: books[k] for k in ("submitted", "ok", "queued", "in_flight", "parked", "balanced")} == {
        "submitted": 4, "ok": 4, "queued": 0, "in_flight": 0, "parked": 0, "balanced": True}
    got = engine.served_tokens[0]
    assert got == want[0][: want[0].index(eos) + 1]
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0


def test_engine_refuses_what_can_never_fit(model):
    """A request whose KV footprint can never fit is refused at admission:
    a first-class ``kv_pages_exhausted`` shed (as the JAX engine books it),
    never a ValueError, and the books stay balanced."""
    engine = _engine(model, GenerationConfig())
    rng = np.random.default_rng(0)
    too_long = RequestSpec(0, 20, 8, rng.integers(0, VOCAB, size=(1, 20)), 0)  # 28 > 24 CA tokens
    too_many = RequestSpec(1, 8, 13, rng.integers(0, VOCAB, size=(1, 8)), 0)  # 4 + 13 > 16 SA tokens
    for spec in (too_long, too_many):
        rec = engine.submit(spec)
        assert rec.outcome == "shed" and rec.shed_reason == "kv_pages_exhausted", rec
    books = engine.books()
    assert books["submitted"] == 2 and books["shed"] == 2 and books["admitted"] == 0 and books["balanced"]
    assert engine.ca_alloc.pages_used == 0 and engine.sa_alloc.pages_used == 0


def test_engine_config_has_no_unported_options():
    """Every option of JAX's ``EngineConfig`` is ported, with JAX's
    defaults: the speculative slot mode off (``spec_k`` 0, ``spec_depth``
    1), prefix sharing on, eviction off."""
    assert EngineConfig().spec_k == 0 and EngineConfig().spec_depth == 1
    assert EngineConfig().prefix_sharing is True and EngineConfig().eviction is False


def test_generate_equals_decode_fns(model):
    spec = _specs(1, seed=7)[0]
    cfg = GenerationConfig(max_new_tokens=spec.max_new_tokens, do_sample=True, temperature=0.7)
    out = generate(model, spec.input_ids, NUM_LATENTS, config=cfg,
                   generator=torch.Generator().manual_seed(spec.rng_seed), device="cpu")
    assert out.shape == (1, spec.prompt_len + spec.max_new_tokens)
    assert out[0, spec.prompt_len:].tolist() == _sequential(model, spec, cfg)


def test_entry_points_default_to_cuda(model):
    """Without ``device="cpu"`` every entry point and cache builder asks for
    the card, and without one it raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = CausalLanguageModelConfig(**CONFIG)
    for call in (
        lambda: CausalLanguageModel(cfg),
        lambda: make_decode_fns(model, NUM_LATENTS),
        lambda: make_paged_step_fn(model),
        lambda: generate(model, np.zeros((1, 8), np.int64), NUM_LATENTS),
        lambda: EngineFrontEnd(model, num_latents=NUM_LATENTS),
        lambda: model.init_cache(model.config, 1),
        lambda: model.init_paged_cache(model.config, 1, 4, 3, 2, 3, 2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
