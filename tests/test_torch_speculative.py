"""The port's speculative self-drafting decode on the CPU (the plain kernel
versions), held to the JAX package (``tests/test_speculative.py``'s
fixtures: vocab 64, 4 latents, seeded JAX parameters carried across with
``convert.state_dict_from_jax``).

Held exactly: greedy streams (the pair's and the engine's) to JAX's
sequential and speculative streams, the greedy accept core to JAX's, the
engine's books, eviction counts and acceptance fields to JAX's speculative
engine on the same plan. Held within 2e-5: ``append_span`` plus the span
attend against JAX's on the same pools, page tables and ragged lengths.
Sampling follows the port's own generator contract (``generation``'s module
docstring): same seed, same stream; after every span the generator sits
where ``advance_generator`` puts a fresh one after the emitted count; the
first emitted token's law is ``p`` (a chi-square test at alpha 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.events import EventLog as JaxEventLog
from perceiver_io_tpu.obs.events import merged_events as jax_merged_events
from perceiver_io_tpu.obs.loadgen import WorkloadSpec as JaxWorkloadSpec
from perceiver_io_tpu_torch import generation as tgen
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.cache import PagedKVCache
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.generation import GenerationConfig, advance_generator
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec

VOCAB = 64
NUM_LATENTS = 4
PAIR_CONFIG = dict(vocab_size=VOCAB, max_seq_len=32, max_latents=16, num_channels=32, num_heads=4,
                   num_self_attention_layers=3, num_self_attention_rotary_layers=-1, cross_attention_dropout=0.5,
                   output_norm=True)
ENGINE_CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=16, num_channels=32, num_heads=4,
                     num_self_attention_layers=2, cross_attention_dropout=0.5)
ENGINE = dict(slots=4, page_size=8, max_ca_tokens=24, max_sa_tokens=12, spec_k=2, spec_depth=1)
SAMPLE = GenerationConfig(do_sample=True, temperature=0.8, top_k=10)


def _pair_models(config, ids, prefix_len, seed):
    jm = JaxCLM(JaxCLMConfig(**config))
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids), prefix_len=prefix_len)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**config), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair_models():
    return _pair_models(PAIR_CONFIG, np.random.default_rng(3).integers(0, VOCAB, size=(1, 12)), 8, 2)


@pytest.fixture(scope="module")
def engine_models():
    return _pair_models(ENGINE_CONFIG, np.random.default_rng(0).integers(0, VOCAB, size=(1, 12)), 8, 0)


def prompt(seq_len=12, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(1, seq_len))


def _jax_sequential(jm, params, ids, cfg, seed=7):
    prefill, step = jgen.make_decode_fns(jm, NUM_LATENTS, jgen.GenerationConfig(**dataclasses.asdict(cfg)))
    tok, state = prefill(params, jnp.asarray(ids), None, jax.random.PRNGKey(seed))
    out = [int(tok[0])]
    for _ in range(cfg.max_new_tokens - 1):
        state, tok = step(state)
        out.append(int(tok[0]))
    return out


def _jax_speculative(jm, params, ids, cfg, k, depth, seed=7):
    prefill, step = jgen.make_speculative_decode_fns(jm, NUM_LATENTS, jgen.GenerationConfig(**dataclasses.asdict(cfg)),
                                                     k=k, draft_depth=depth)
    tok, state = prefill(params, jnp.asarray(ids), None, jax.random.PRNGKey(seed))
    out = [int(tok[0])]
    while len(out) < cfg.max_new_tokens:
        state, toks, m = step(state)
        out.extend(int(t) for t in np.asarray(toks[0, : int(m[0])]))
    return out


def _speculative(tm, ids, cfg, k, depth, seed=7, boundaries=None):
    """The port's pair driven to the budget; ``boundaries`` collects
    (emitted count, generator state) after every span."""
    prefill, step = tgen.make_speculative_decode_fns(tm, NUM_LATENTS, cfg, k=k, draft_depth=depth, device="cpu")
    generator = torch.Generator().manual_seed(seed)
    tok, state = prefill(ids, None, generator)
    out = [int(tok[0])]
    while len(out) < cfg.max_new_tokens:
        state, toks, m = step(state)
        out.extend(int(t) for t in toks[0, : int(m[0])])
        if boundaries is not None:
            boundaries.append((len(out), generator.get_state().clone()))
    return out, generator


# ------------------------------------------------------------ the pair


@pytest.mark.parametrize("k,depth", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_speculative_greedy_stream_equals_jax(pair_models, k, depth):
    """Greedy: the port's speculative stream is JAX's sequential stream and
    JAX's speculative stream token for token; the generator is untouched."""
    jm, params, tm = pair_models
    ids = prompt()
    cfg = GenerationConfig(max_new_tokens=10)
    out, generator = _speculative(tm, ids, cfg, k, depth)
    seq = _jax_sequential(jm, params, ids, cfg)
    assert out[: cfg.max_new_tokens] == seq
    assert _jax_speculative(jm, params, ids, cfg, k, depth)[: cfg.max_new_tokens] == seq
    assert torch.equal(generator.get_state(), torch.Generator().manual_seed(7).get_state())


def test_speculative_eos_stream_equals_jax(pair_models):
    """EOS mid-stream: the stream freezes to PAD where JAX's does (the done
    flag latches per emitted token)."""
    jm, params, tm = pair_models
    ids = prompt()
    base = _jax_sequential(jm, params, ids, GenerationConfig(max_new_tokens=10))
    eos = next(t for t in base[1:] if t != base[0])
    cfg = GenerationConfig(max_new_tokens=10, eos_token_id=int(eos), pad_token_id=63)
    want = _jax_sequential(jm, params, ids, cfg)
    out, _ = _speculative(tm, ids, cfg, 3, 1)
    assert out[: len(want)] == want
    assert _jax_speculative(jm, params, ids, cfg, 3, 1)[: len(want)] == want
    assert eos in want and want[want.index(eos) + 1:] == [63] * (9 - want.index(eos))


def test_speculative_sampling_same_seed_and_generator_position(pair_models):
    """Sampling: the same seed gives the same stream, every token lies in
    the vocabulary, and after every span the generator equals a fresh one
    of the seed advanced by the emitted count."""
    _, _, tm = pair_models
    ids = prompt()
    cfg = dataclasses.replace(SAMPLE, max_new_tokens=10)
    b1, b2 = [], []
    out1, _ = _speculative(tm, ids, cfg, 2, 1, seed=9, boundaries=b1)
    out2, _ = _speculative(tm, ids, cfg, 2, 1, seed=9, boundaries=b2)
    assert out1 == out2 and all(0 <= t < VOCAB for t in out1)
    assert len(b1) >= 2
    for (n, state), (n2, state2) in zip(b1, b2):
        want = advance_generator(torch.Generator().manual_seed(9), n, cfg).get_state()
        assert n == n2 and torch.equal(state, want) and torch.equal(state2, want)


# ------------------------------------------------------------ the drafter


def test_drafter_caches_are_the_flagship_prefix_and_their_own_storage(pair_models):
    """The drafter shares the flagship's modules, so its prompt pass fills
    exactly the flagship prefill caches' prefix; the pair's drafter caches
    are copies of that prefix, and a write into one leaves the other bit
    for bit as it was."""
    _, _, tm = pair_models
    ids = torch.as_tensor(prompt())
    depth = 2
    drafter = tgen.make_drafter(tm, depth)
    assert drafter.cross_attention is tm.cross_attention and drafter.self_attention[1] is tm.self_attention[1]
    assert len(drafter.self_attention) == depth and drafter.config.num_self_attention_layers == depth
    flag = tm(ids, prefix_len=8, kv_cache=CausalSequenceModel.init_cache(tm.config, 1, 20, 12, device="cpu"))
    draft = drafter(ids, prefix_len=8, kv_cache=CausalSequenceModel.init_cache(drafter.config, 1, 20, 12,
                                                                               device="cpu"))
    assert len(draft.kv_cache) == 1 + depth
    for got, want in zip(draft.kv_cache, flag.kv_cache[: 1 + depth]):
        assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
    prefill, _ = tgen.make_speculative_decode_fns(tm, NUM_LATENTS, GenerationConfig(max_new_tokens=4), k=2,
                                                  draft_depth=depth, device="cpu")
    _, state = prefill(ids)
    for dc, fc in zip(state["draft_cache"], state["cache"]):
        assert torch.equal(dc.k, fc.k) and torch.equal(dc.v, fc.v) and int(dc.length) == int(fc.length)
        assert dc.k.data_ptr() != fc.k.data_ptr() and dc.length.data_ptr() != fc.length.data_ptr()
        before = fc.k.clone()
        dc.k.add_(1.0)
        assert torch.equal(fc.k, before)


@pytest.mark.parametrize("depth", [0, 3, 7])
def test_make_drafter_rejects_bad_depth(pair_models, depth):
    jm, _, tm = pair_models
    with pytest.raises(ValueError, match=r"draft_depth must be in \[1..2\]"):
        jgen.make_drafter(jm, depth)
    with pytest.raises(ValueError, match=r"draft_depth must be in \[1..2\]"):
        tgen.make_drafter(tm, depth)


def test_speculative_validations(pair_models):
    """Where JAX's pair raises, the port's does: batch 1 only, a window that
    would slide, k < 1, a budget under 1."""
    jm, params, tm = pair_models
    ids = prompt()
    two = np.concatenate([ids, ids])
    for make, call in ((lambda *a, **kw: jgen.make_speculative_decode_fns(jm, *a, **kw),
                        lambda prefill, x: prefill(params, jnp.asarray(x), None, None)),
                       (lambda *a, **kw: tgen.make_speculative_decode_fns(tm, *a, device="cpu", **kw),
                        lambda prefill, x: prefill(x))):
        prefill, _ = make(NUM_LATENTS, GenerationConfig(max_new_tokens=4), k=2)
        with pytest.raises(ValueError, match="batch 1"):
            call(prefill, two)
        prefill, _ = make(8, GenerationConfig(max_new_tokens=12), k=2)
        with pytest.raises(ValueError, match="does not slide the window"):
            call(prefill, ids)
        with pytest.raises(ValueError, match="must be >= 1"):
            make(NUM_LATENTS, GenerationConfig(max_new_tokens=4), k=0)
        with pytest.raises(ValueError, match="max_new_tokens >= 1"):
            make(NUM_LATENTS, GenerationConfig(max_new_tokens=0), k=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        tgen.make_speculative_paged_step_fn(tm, GenerationConfig(), k=0, device="cpu")


# ------------------------------------------------------------ the accept core


@pytest.mark.parametrize("eos", [None, 5])
def test_speculative_accept_greedy_equals_jax(eos):
    """The greedy accept core on seeded drafts and logits (drafts that agree
    with the flagship's argmax for a seeded run of positions, so every
    accepted count occurs): tokens, m, new_token and done exactly JAX's."""
    rng = np.random.default_rng(11)
    b, k, v = 24, 4, 16
    p = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    q = rng.standard_normal((b, k, v)).astype(np.float32)
    agree = rng.integers(0, k + 1, size=b)
    drafts = np.where(np.arange(k)[None, :] < agree[:, None], p[:, :k].argmax(-1),
                      rng.integers(0, v, size=(b, k))).astype(np.int32)
    drafts[0] = 5  # an EOS draft accepted where the flagship agrees
    p[0, :k, 5] = 10.0
    done = rng.random(b) < 0.2
    cfg = GenerationConfig(eos_token_id=eos, pad_token_id=1)
    jtok, jm, jnew, _, jdone = jgen._speculative_accept(jgen.GenerationConfig(**dataclasses.asdict(cfg)),
                                                        jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p),
                                                        jnp.zeros((b, 2), jnp.uint32), jnp.asarray(done))
    tok, m, new, tdone = tgen._speculative_accept(cfg, torch.as_tensor(drafts).long(), torch.as_tensor(q),
                                                  torch.as_tensor(p), torch.as_tensor(done))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert set(m.tolist()) == set(range(1, k + 2))


def test_speculative_accept_first_token_law():
    """Rejection sampling over a 4-token vocabulary with fixed p and q, k = 2
    and 20 000 seeded spans: the first emitted token's frequencies pass a
    chi-square test against p at alpha = 1e-3 (3 degrees of freedom:
    critical value 16.27). The drafts are drawn from q at the spans' own
    drafter draws, as the step draws them."""
    n, k = 20_000, 2
    p = torch.tensor([0.1, 0.2, 0.3, 0.4])
    q = torch.tensor([0.4, 0.3, 0.2, 0.1])
    cfg = GenerationConfig(do_sample=True)
    u = torch.stack([tgen._span_draws(torch.Generator().manual_seed(1000 + i), k) for i in range(n)])
    q_logits = q.log().expand(n, k, 4)
    p_logits = p.log().expand(n, k + 1, 4)
    drafts = torch.stack([tgen._sample_at(q_logits[:, i], cfg, u[:, k + 1 + i]) for i in range(k)], dim=1)
    tokens, m, _, _ = tgen._speculative_accept(cfg, drafts, q_logits, p_logits, torch.zeros(n, dtype=torch.bool), u)
    counts = torch.bincount(tokens[:, 0], minlength=4).double()
    chi2 = float(((counts - n * p.double()) ** 2 / (n * p.double())).sum())
    assert chi2 < 16.27, (chi2, counts.tolist())
    assert 1 <= int(m.min()) and int(m.max()) <= k + 1 and float(m.float().mean()) > 1.0


# ------------------------------------------------------------ the span attend


def test_append_span_and_span_attend_match_jax():
    """``PagedKVCache.append_span`` plus ``_paged_span_attend`` against JAX's
    on the same pools, page tables and ragged lengths (an idle slot on the
    scratch page among them), with a pad mask and rotary encodings: the
    appended pools (keys rotated at write) and the attention output within
    2e-5 (f32), every row outside the span untouched."""
    from perceiver_io_tpu.core import cache as jcache
    from perceiver_io_tpu.core.attention import MultiHeadAttention as JaxMHA
    from perceiver_io_tpu_torch.core.attention import MultiHeadAttention

    rng = np.random.default_rng(5)
    s, page, pages_per_slot, n_pages, c, h, n_q = 4, 4, 3, 14, 32, 4, 3
    pool_k = rng.standard_normal((n_pages, page, c)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, page, c)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0], [6, 7, 8]], np.int32)
    length = np.array([5, 2, 0, 7], np.int32)
    x = rng.standard_normal((s, n_q, c)).astype(np.float32)
    pad = np.zeros((s, pages_per_slot * page), bool)
    pad[0, 1] = pad[3, :2] = True
    rope = rng.standard_normal((s, n_q, c // h)).astype(np.float32)
    jmha = JaxMHA(num_heads=h, num_q_input_channels=c, num_kv_input_channels=c, causal_attention=True)
    jparams = jmha.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x))
    jc = jcache.PagedKVCache(k=jnp.asarray(pool_k), v=jnp.asarray(pool_v), page_table=jnp.asarray(table),
                             length=jnp.asarray(length))
    jout = jmha.apply(jparams, jnp.asarray(x), jnp.asarray(x), pad_mask=jnp.asarray(pad), rope_q=jnp.asarray(rope),
                      rope_k=jnp.asarray(rope), kv_cache=jc)
    tmha = MultiHeadAttention(num_heads=h, num_q_input_channels=c, num_kv_input_channels=c, causal_attention=True)
    p = jax.tree.map(np.asarray, jparams)["params"]
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            getattr(tmha, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            getattr(tmha, name).bias.copy_(torch.from_numpy(p[name]["bias"].copy()))
    tc = PagedKVCache(torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy()), torch.from_numpy(table),
                      torch.from_numpy(length))
    with torch.no_grad():
        tout = tmha(torch.from_numpy(x), torch.from_numpy(x), pad_mask=torch.from_numpy(pad),
                    rope_q=torch.from_numpy(rope), rope_k=torch.from_numpy(rope), kv_cache=tc)
    np.testing.assert_array_equal(tout.kv_cache.length.numpy(), np.asarray(jout.kv_cache.length))
    for got, want in ((tc.k, jout.kv_cache.k), (tc.v, jout.kv_cache.v), (tout.last_hidden_state,
                                                                      jout.last_hidden_state)):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= 2e-5, err
    # only the span's rows moved: every other pool row is as it was
    written = np.zeros((n_pages, page), bool)
    for slot in range(s):
        for pos in range(length[slot], length[slot] + n_q):
            written[table[slot, min(pos // page, pages_per_slot - 1)], pos % page] = True
    assert np.array_equal(tc.k.numpy()[~written], pool_k[~written])
    assert np.array_equal(tc.v.numpy()[~written], pool_v[~written])


# ------------------------------------------------------------ the engine


def _spec_engine(tm, base=None, **kw):
    engine = dict(ENGINE, **kw.pop("engine", {}))
    return serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, base_config=base, device="cpu",
                                  engine_config=serving.EngineConfig(**engine), **kw)


def _jax_spec_engine(jm, params, base=None, **kw):
    engine = dict(ENGINE, **kw.pop("engine", {}))
    base = None if base is None else jgen.GenerationConfig(**dataclasses.asdict(base))
    return jax_serving.EngineFrontEnd(jm, params, num_latents=NUM_LATENTS, base_config=base,
                                      engine_config=jax_serving.EngineConfig(**engine), **kw)


def _sequential(tm, spec, base=None):
    cfg = dataclasses.replace(base or GenerationConfig(), max_new_tokens=spec.max_new_tokens)
    prefill, step = tgen.make_decode_fns(tm, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec.input_ids, None, torch.Generator().manual_seed(spec.rng_seed))
    out = [int(token[0])]
    for _ in range(spec.max_new_tokens - 1):
        state, token = step(state)
        out.append(int(token[0]))
    return out


def _jax_sequential_spec(jm, params, spec, base=None):
    cfg = dataclasses.replace(base or GenerationConfig(), max_new_tokens=spec.max_new_tokens)
    return _jax_sequential(jm, params, spec.input_ids, cfg, seed=spec.rng_seed)


def _streams(fe):
    return {i: [int(t) for t in s] for i, s in fe.served_tokens.items()}


def _clean(fe):
    assert fe.books()["balanced"] and fe.audit() == []
    assert fe.ca_alloc.pages_used == 0 and fe.sa_alloc.pages_used == 0
    assert fe.ca_alloc.audit() == [] and fe.sa_alloc.audit() == []


def test_spec_engine_ragged_greedy_streams_equal_jax(engine_models):
    """Ragged batches (mixed prompts and budgets, joins and retires
    mid-flight) through the speculative slot mode: every stream JAX's
    sequential stream and the port's; books, audit and page books clean;
    every slot's drafter pools back on the scratch page."""
    jm, params, tm = engine_models
    specs = WorkloadSpec(seed=13, prompt_lens=(8, 12), max_new_tokens=(4, 8)).draw(8, VOCAB)
    fe = _spec_engine(tm)
    recs = fe.run_closed(specs, concurrency=8)
    assert all(r.outcome == "ok" for r in recs)
    _clean(fe)
    for pool in fe._state["draft_cache"]:
        assert int(pool.page_table.abs().sum()) == 0
    for spec in specs:
        want = _jax_sequential_spec(jm, params, spec)
        assert fe.served_tokens[spec.index] == want == _sequential(tm, spec), spec.index


def test_spec_engine_open_loop_streams_equal(engine_models):
    """Poisson arrivals through the speculative batched path: every stream
    the sequential one, books clean."""
    _, _, tm = engine_models
    wspec = WorkloadSpec(seed=5, prompt_lens=(10,), max_new_tokens=(6,))
    fe = _spec_engine(tm)
    recs = fe.run_open(wspec.draw(8, VOCAB), rate_rps=200.0)
    assert all(r.outcome == "ok" for r in recs)
    _clean(fe)
    for spec in wspec.draw(8, VOCAB):
        assert fe.served_tokens[spec.index] == _sequential(tm, spec)


def test_spec_engine_eos_equals_jax(engine_models):
    """EOS retires a speculative slot at the token the sequential path stops
    at; span tokens past it are never served; the streams are JAX's spec
    engine's."""
    jm, params, tm = engine_models
    specs = WorkloadSpec(seed=5, prompt_lens=(10,), max_new_tokens=(8,)).draw(4, VOCAB)
    seq0 = _sequential(tm, specs[0])
    eos = next(t for t in seq0[1:] if t != seq0[0])
    base = GenerationConfig(eos_token_id=int(eos))
    fe = _spec_engine(tm, base)
    recs = fe.run_closed(specs, concurrency=4)
    assert fe.books()["balanced"] and all(r.outcome == "ok" for r in recs)
    assert any(r.tokens_out < r.max_new_tokens for r in recs), "no request ended at EOS: the check is vacuous"
    jfe = _jax_spec_engine(jm, params, base)
    jfe.run_closed(JaxWorkloadSpec(seed=5, prompt_lens=(10,), max_new_tokens=(8,)).draw(4, VOCAB), concurrency=4)
    assert _streams(jfe) == _streams(fe)
    for spec in specs:
        want = _sequential(tm, spec, base)
        got = fe.served_tokens[spec.index]
        assert got == want[: len(got)]
        if len(got) < spec.max_new_tokens:
            assert got[-1] == int(eos)


def test_spec_engine_kill_mid_span_books_as_jax(engine_models, tmp_path):
    """A kill landing mid-span: the slot retires at the killed token, the
    span's remainder dropped; books, records and streams JAX's spec
    engine's on the same plan."""
    jm, params, tm = engine_models
    specs = WorkloadSpec(seed=6, prompt_lens=(10,), max_new_tokens=(6,)).draw(3, VOCAB)
    fe = _spec_engine(tm, events=EventLog(str(tmp_path / "port"), main_process=True),
                      injector=serving.FaultInjector().kill_at(1, 2))
    recs = fe.run_closed(specs, concurrency=3)
    books = fe.books()
    assert books["error"] == 1 and books["ok"] == 2 and books["balanced"], books
    dead = next(r for r in recs if r.outcome == "error")
    assert dead.index == 1 and dead.tokens_out == 3 and len(fe.served_tokens[1]) == 3
    assert fe.ca_alloc.pages_used == 0 and fe.sa_alloc.pages_used == 0
    jfe = _jax_spec_engine(jm, params, events=JaxEventLog(str(tmp_path / "jax"), main_process=True),
                           injector=jax_serving.FaultInjector().kill_at(1, 2))
    jfe.run_closed(JaxWorkloadSpec(seed=6, prompt_lens=(10,), max_new_tokens=(6,)).draw(3, VOCAB), concurrency=3)
    jbooks = jfe.books()
    assert {k: jbooks[k] for k in ("ok", "error", "submitted", "balanced")} == \
        {k: books[k] for k in ("ok", "error", "submitted", "balanced")}
    assert [(r.index, r.outcome, r.tokens_out) for r in jfe.records] == [(r.index, r.outcome, r.tokens_out)
                                                                        for r in fe.records]
    assert _streams(jfe) == _streams(fe)


def test_spec_engine_acceptance_fields_equal_jax(engine_models, tmp_path):
    """Every request row carries ``acceptance_rate`` / ``tokens_per_step``
    (valid events, no warnings), equal to JAX's spec engine's on the same
    plan, and the registry's spec histograms hold one sample a request."""
    jm, params, tm = engine_models
    fe = _spec_engine(tm, events=EventLog(str(tmp_path / "port"), main_process=True))
    fe.run_closed(WorkloadSpec(seed=4, prompt_lens=(10,), max_new_tokens=(6,)).draw(5, VOCAB), concurrency=5)
    warnings_out = []
    assert validate_events(str(tmp_path / "port"), warnings_out=warnings_out) == [] and warnings_out == []
    jfe = _jax_spec_engine(jm, params, events=JaxEventLog(str(tmp_path / "jax"), main_process=True))
    jfe.run_closed(JaxWorkloadSpec(seed=4, prompt_lens=(10,), max_new_tokens=(6,)).draw(5, VOCAB), concurrency=5)

    def fields(rows):
        return sorted((r["prompt_len"], r["tokens_out"], r["acceptance_rate"], r["tokens_per_step"])
                      for r in rows if r.get("event") == "request")

    got = fields(merged_events(str(tmp_path / "port")))
    assert len(got) == 5 and got == fields(jax_merged_events(str(tmp_path / "jax")))
    assert all(0.0 <= a <= 1.0 and t >= 1.0 for _, _, a, t in got)
    snap = fe.registry.snapshot()["histograms"]
    assert snap["spec_acceptance_rate"]["n"] == 5 and snap["spec_tokens_per_step"]["n"] == 5


def test_spec_engine_prefill_filled_budget_rides_no_span(engine_models, tmp_path):
    """A request whose budget the prefill token fills retires before the
    batched step: its row carries no acceptance fields, and the spec
    histograms count only the requests that rode spans."""
    _, _, tm = engine_models
    fe = _spec_engine(tm, events=EventLog(str(tmp_path), main_process=True))
    specs = WorkloadSpec(seed=9, prompt_lens=(10,), max_new_tokens=(1, 6)).draw(6, VOCAB)
    assert {s.max_new_tokens for s in specs} == {1, 6}
    recs = fe.run_closed(specs, concurrency=6)
    assert all(r.outcome == "ok" for r in recs)
    _clean(fe)
    for spec in specs:
        assert fe.served_tokens[spec.index] == _sequential(tm, spec)
    assert validate_events(str(tmp_path), warnings_out=[]) == []
    for row in (e for e in merged_events(str(tmp_path)) if e.get("event") == "request"):
        if row["tokens_out"] == 1:
            assert "acceptance_rate" not in row and "tokens_per_step" not in row, row
        else:
            assert row["tokens_per_step"] >= 1.0, row
    n_spanned = sum(1 for s in specs if s.max_new_tokens > 1)
    assert fe.registry.snapshot()["histograms"]["spec_tokens_per_step"]["n"] == n_spanned


def test_spec_engine_rejects_sliding_window_geometry(engine_models):
    """The construction-time no-slide check, as JAX's."""
    jm, params, tm = engine_models
    sliding = dict(slots=2, page_size=8, max_ca_tokens=24, max_sa_tokens=24, spec_k=2)
    with pytest.raises(ValueError, match="never slides the window"):
        jax_serving.EngineFrontEnd(jm, params, num_latents=NUM_LATENTS,
                                   engine_config=jax_serving.EngineConfig(**sliding))
    with pytest.raises(ValueError, match="never slides the window"):
        serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu",
                               engine_config=serving.EngineConfig(**sliding))


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_spec_engine_sampled_streams_keep_the_generator_contract(engine_models, sampling):
    """Sampled spans in the engine: the same specs twice give the same
    streams, and a request's stream does not depend on its neighbours (one
    request alone serves the tokens it serves in a batch of eight)."""
    _, _, tm = engine_models
    base = GenerationConfig() if sampling == "greedy" else SAMPLE
    specs = WorkloadSpec(seed=21, prompt_lens=(8, 12), max_new_tokens=(4, 8)).draw(8, VOCAB)
    runs = []
    for batch in (specs, specs, specs[3:4]):
        fe = _spec_engine(tm, base)
        fe.run_closed(batch, concurrency=len(batch))
        _clean(fe)
        runs.append(_streams(fe))
    assert runs[0] == runs[1] and runs[2][3] == runs[0][3]


# ------------------------------------------------------------ eviction, journal, sharing


def test_spec_engine_eviction_equals_jax(engine_models):
    """Spec mode with eviction at pool headroom 0.5: greedy streams,
    eviction and resume counts and records JAX's spec engine's on the same
    specs; every stream the sequential one."""
    jm, params, tm = engine_models
    specs = WorkloadSpec(seed=13, prompt_lens=(8, 12), max_new_tokens=(4, 8)).draw(8, VOCAB)
    kw = dict(engine=dict(pool_headroom=0.5, eviction=True))
    fe = _spec_engine(tm, **kw)
    fe.run_closed(specs, concurrency=8)
    books = fe.books()
    assert books["evictions"] >= 1 and books["evictions"] == books["resumes"] and books["ok"] == 8, books
    _clean(fe)
    jfe = _jax_spec_engine(jm, params, **kw)
    jfe.run_closed(JaxWorkloadSpec(seed=13, prompt_lens=(8, 12), max_new_tokens=(4, 8)).draw(8, VOCAB),
                   concurrency=8)
    jbooks = jfe.books()
    assert {k: jbooks[k] for k in ("ok", "evictions", "resumes", "parked", "balanced")} == \
        {k: books[k] for k in ("ok", "evictions", "resumes", "parked", "balanced")}
    assert [(r.index, r.outcome, r.tokens_out, r.attempts) for r in jfe.records] == \
        [(r.index, r.outcome, r.tokens_out, r.attempts) for r in fe.records]
    assert _streams(jfe) == _streams(fe)
    for spec in specs:
        assert fe.served_tokens[spec.index] == _sequential(tm, spec)


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_spec_engine_journal_recovered_streams_exact(engine_models, tmp_path, sampling):
    """A spec engine dies mid-decode; a fresh spec engine recovers its
    journal by replay, its generators advanced by the served counts. Greedy,
    every stream is the sequential one. Sampled, each stream keeps the
    tokens journaled before the crash (an uninterrupted spec engine's), and two
    recoveries of the same journal serve the same streams: after a resume
    the spans start at other token counts than the uninterrupted run's, and
    a span's drafter draws hang on its start, so the rest is another draw of
    the same law. The journal's books balance across the restart."""
    import shutil

    _, _, tm = engine_models
    base = GenerationConfig() if sampling == "greedy" else SAMPLE
    specs = WorkloadSpec(seed=17, prompt_lens=(8, 12), max_new_tokens=(6, 8)).draw(6, VOCAB)
    whole = _spec_engine(tm, base)
    whole.run_closed(specs, concurrency=6)
    jpath = str(tmp_path / "journal.jsonl")
    fe1 = _spec_engine(tm, base, journal=jpath, injector=serving.FaultInjector().crash_at(2, 3))
    with pytest.raises(serving.EngineCrash):
        fe1.run_closed(specs, concurrency=6)
    shutil.copy(jpath, str(tmp_path / "copy.jsonl"))
    before = {i: list(e.tokens) for i, e in serving.RequestJournal(jpath).replay().items()}
    replays = []
    for path in (jpath, str(tmp_path / "copy.jsonl")):
        fe2 = _spec_engine(tm, base)
        info = fe2.recover(path)
        assert info["recovered"] >= 1 and info["parked"] >= 1, info
        fe2.pump()
        _clean(fe2)
        journal = serving.RequestJournal(path)
        jb = journal.books()
        assert jb["balanced"] and jb["pending"] == 0 and jb["outcomes"] == {"ok": 6}, jb
        replays.append({i: e.tokens for i, e in journal.replay().items()})
    assert replays[0] == replays[1]
    for spec in specs:
        got = replays[0][spec.index]
        assert len(got) == spec.max_new_tokens and all(0 <= t < VOCAB for t in got)
        n = len(before.get(spec.index, []))
        assert got[:n] == before.get(spec.index, []) == whole.served_tokens[spec.index][:n]
        if sampling == "greedy":
            assert got == _sequential(tm, spec)


def test_spec_engine_gates_sharing_off(engine_models):
    """Prefix sharing is off in the speculative slot mode (as in JAX): two
    prompts with a common page join unshared, nothing is published, and
    the streams are the sequential ones."""
    _, _, tm = engine_models
    specs = WorkloadSpec(seed=2, prompt_lens=(12,), max_new_tokens=(4,), shared_prefix_len=8).draw(4, VOCAB)
    fe = _spec_engine(tm, engine=dict(prefix_sharing=True))
    fe.run_closed(specs, concurrency=2)
    _clean(fe)
    assert fe.books().get("prefix_hits", 0) == 0 and fe._n_prefix_hits == 0
    assert fe.prefix_index.pages() == () and fe.sharing_audit() == []
    for spec in specs:
        assert fe.served_tokens[spec.index] == _sequential(tm, spec)
