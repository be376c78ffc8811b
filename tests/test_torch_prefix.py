"""The port's prefix sharing on the CPU (the plain kernel versions), held to
the JAX package: the radix prefix index side by side with JAX's on the same
insert/match/expire sequences; ``pos_offset`` on the model's forward;
``generation.make_shared_prefill_fn`` against JAX's (first token, logits, CA
rows) and against the port's unshared prefill; the engine's sharing
token-exact (greedy against JAX's engine, sampled against the port's own
sequential stream) and isolated, with the allocator and the index drained
clean; recovery that rebuilds the refcounts and shares again; the
copy-on-write fork that copies a page in place; the latent-region refusal;
and the route the shared prefill's cross-attention takes, K2 over a filled
contiguous cache, against the dense path (causal, right-aligned).

Tolerances: logits and cache rows within 2e-5 of JAX's (f32, both on the
CPU); the shared prefill against the port's unshared one within 1e-5 (the
same kernels, on projections of other row counts); the K2 route against the
dense path within 1e-5 in f32, and in bf16 within 1e-2 in L2 relative to the
output's norm (K2's plain version keeps ``p`` in f32, the dense path rounds
the probabilities to bf16 before ``P V``: a few outputs differ by a bf16
step or two)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jax_generation
from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.loadgen import WorkloadSpec as JaxWorkloadSpec
from perceiver_io_tpu.serving import prefix as jax_prefix
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.core.cache import init_kv_cache
from perceiver_io_tpu_torch.generation import (
    GenerationConfig,
    make_decode_fns,
    make_prefill_fn,
    make_shared_prefill_fn,
)
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec
from perceiver_io_tpu_torch.serving import prefix as torch_prefix

NUM_LATENTS, VOCAB = 4, 64
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
SAMPLERS = {"greedy": GenerationConfig(), "temperature": GenerationConfig(do_sample=True, temperature=0.8, top_k=10)}


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _engine(tm, base=None, *, max_sa_tokens=16, **kw):
    return serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, base_config=base, device="cpu",
                                  engine_config=serving.EngineConfig(slots=4, page_size=8, max_ca_tokens=24,
                                                                     max_sa_tokens=max_sa_tokens), **kw)


def _jax_engine(jm, params, **kw):
    return jax_serving.EngineFrontEnd(jm, params, num_latents=NUM_LATENTS,
                                      engine_config=jax_serving.EngineConfig(slots=4, page_size=8, max_ca_tokens=24,
                                                                             max_sa_tokens=16), **kw)


def _shared_specs(workload, n, seed=21):
    # prompt 16, 4 latents: a 12-token context, one whole shareable page
    return workload(seed=seed, prompt_lens=(16,), max_new_tokens=(3, 4), shared_prefix_len=8).draw(n, VOCAB)


def _sequential(tm, spec, base=None):
    cfg = dataclasses.replace(base or GenerationConfig(), max_new_tokens=spec.max_new_tokens)
    prefill, step = make_decode_fns(tm, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec.input_ids, None, torch.Generator().manual_seed(spec.rng_seed))
    out = [int(token[0])]
    for _ in range(spec.max_new_tokens - 1):
        state, token = step(state)
        out.append(int(token[0]))
    return out


# ------------------------------------------------------------- radix index


@pytest.mark.parametrize("mod", [jax_prefix, torch_prefix], ids=["jax", "torch"])
def test_prefix_index_insert_match_roundtrip(mod):
    idx = mod.PrefixIndex(8)
    prompt = list(range(20))  # 2 full chunks + a 4-token partial tail
    assert idx.insert(prompt[:16], [5, 6]) == 2
    assert idx.match(prompt) == (5, 6)
    assert idx.match(prompt[:12]) == (5,)
    assert idx.pages() == (5, 6) and len(idx) == 2 and idx.audit() == []
    assert idx.insert(prompt[:16], [5, 6]) == 0


@pytest.mark.parametrize("mod", [jax_prefix, torch_prefix], ids=["jax", "torch"])
def test_prefix_index_partial_tail_never_matches(mod):
    idx = mod.PrefixIndex(8)
    prompt = list(range(20))
    with pytest.raises(ValueError, match="full chunks"):
        idx.insert(prompt, [5, 6, 7])
    idx.insert(prompt[:16], [5, 6])
    assert idx.match(prompt[:8] + [99] * 8) == (5,)
    assert idx.match(prompt[:4]) == ()
    assert idx.match(prompt[:4] + [99] * 8) == ()
    assert idx.match([99] + prompt[:8]) == ()


@pytest.mark.parametrize("mod", [jax_prefix, torch_prefix], ids=["jax", "torch"])
def test_prefix_index_expire_and_reinsert(mod):
    idx = mod.PrefixIndex(8)
    prompt = list(range(24))
    idx.insert(prompt, [3, 4, 5])
    assert idx.expire_pages([4]) == 2  # the node and its child
    assert idx.match(prompt) == (3,) and idx.pages() == (3,) and len(idx) == 1
    assert idx.expire_pages([99]) == 0
    assert idx.insert(prompt[:16], [7, 8]) == 1  # repoints chunk 1 to 7, adds chunk 2 at 8
    assert idx.match(prompt) == (7, 8) and idx.pages() == (7, 8) and idx.audit() == []


def test_prefix_index_agrees_with_jax_on_random_histories():
    """The same random insert/match/expire history through both indexes, as
    the engine makes one (a publish names its match's pages, then fresh ones
    never named before; an expire names live pages, sometimes unknown ones):
    every answer (new nodes, matches, pages, nodes expired, chunk keys,
    audits) equal, step by step."""
    rng = np.random.default_rng(4)
    for page_size in (1, 4, 8):
        ours, theirs = torch_prefix.PrefixIndex(page_size), jax_prefix.PrefixIndex(page_size)
        prompts = [rng.integers(0, 3, size=int(rng.integers(1, 40))).tolist() for _ in range(12)]
        fresh = 1
        for _ in range(300):
            op = rng.integers(3)
            prompt = prompts[rng.integers(len(prompts))]
            if op == 0:
                head = list(theirs.match(prompt))
                n = int(rng.integers(len(head), len(prompt) // page_size + 1))
                pages = head[:n] + list(range(fresh, fresh + n - len(head[:n])))
                fresh += n
                assert ours.insert(prompt, pages) == theirs.insert(prompt, pages)
            elif op == 1:
                assert ours.match(prompt) == theirs.match(prompt)
            else:
                live = list(theirs.pages())
                pages = [int(p) for p in rng.choice(live, size=min(2, len(live)), replace=False)] + [10**6]
                assert ours.expire_pages(pages) == theirs.expire_pages(pages)
            assert ours.pages() == theirs.pages() and len(ours) == len(theirs)
            assert ours.audit() == theirs.audit() == []
        assert ours.chunks(prompts[0]) == theirs.chunks(prompts[0])
    assert torch_prefix.chunk_key([1, 2, 3]) == jax_prefix.chunk_key([1, 2, 3])


def test_deferred_inserts_answer_as_jax_eager_index():
    """The engine's deferred publish against JAX's eager index on the same
    random history: a join matches (``match_first``) and publishes its head
    plus fresh pages (``defer_insert``; JAX inserts), a publish of fresh
    pages that matched nothing first (``defer_insert``, which inserts at
    once where a run already leads), a resume republishes at once over
    fresh pages (``insert_keys`` both), and a free drops the
    owner's refcounts (``withdraw`` then ``expire_pages`` of the released
    pages; JAX expires). Every match equal step by step, the whole index
    (pages, nodes, audit) equal every 16 steps, and a run that was withdrawn
    before anything read its subtree never hashed its keys."""
    rng = np.random.default_rng(5)
    for page_size in (1, 4):
        ours, theirs = torch_prefix.PrefixIndex(page_size), jax_prefix.PrefixIndex(page_size)
        prompts = [rng.integers(0, 3, size=int(rng.integers(page_size, 40))).tolist() for _ in range(10)]
        live, rc, fresh, hashed, deferred = {}, {}, 1, [], 0
        for step in range(500):
            op = rng.integers(5)
            if op < 3 or not live:
                owner, prompt = step, prompts[rng.integers(len(prompts))]
                keys = ours.chunks(prompt)
                head = ()
                if op == 0:
                    head = ours.match_first(keys[0], lambda: keys) if keys else ()
                    assert head == theirs.match(prompt)
                n = len(keys)
                pages = list(head) + list(range(fresh, fresh + n - len(head)))
                fresh += n
                for p in pages:
                    rc[p] = rc.get(p, 0) + 1
                live[owner] = pages
                if op != 1 and keys:
                    deferred += 1
                    ours.defer_insert(owner, keys[0], lambda keys=keys, owner=owner: hashed.append(owner) or keys,
                                      pages)
                else:  # a resume: eager, over fresh pages
                    ours.insert_keys(keys, pages)
                theirs.insert(prompt, pages)
            else:
                owner = list(live)[rng.integers(len(live))]
                released = []
                for p in live.pop(owner):
                    rc[p] -= 1
                    if rc[p] == 0:
                        released.append(p)
                        del rc[p]
                ours.withdraw(owner)
                assert ours.expire_pages(released) >= 0
                theirs.expire_pages(released)
            for prompt in prompts[:3]:
                assert ours.match(prompt) == theirs.match(prompt)
            if step % 16 == 15:
                assert ours.pages() == theirs.pages() and len(ours) == len(theirs)
                assert ours.audit() == theirs.audit() == []
        assert len(set(hashed)) == len(hashed) < deferred


# ------------------------------------------------------------- pos_offset


@pytest.mark.parametrize("offset", [0, 5, 12])
def test_pos_offset_forward_matches_jax(models, offset):
    jm, params, tm = models
    ids = np.random.default_rng(offset).integers(0, VOCAB, size=(2, 10))
    want = jm.apply(params, jnp.asarray(ids), prefix_len=6, pos_offset=offset).logits
    with torch.no_grad():
        got = tm(torch.as_tensor(ids), prefix_len=6, pos_offset=offset).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_pos_offset_shifts_the_positions_of_a_suffix(models):
    """The suffix forward at ``pos_offset`` sees the positions the whole
    prompt's forward gives its tokens: with the prefix out of reach
    (``prefix_len`` 0), the suffix's latents are those of a prompt whose
    prefix is dropped entirely, position by position."""
    _, _, tm = models
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, VOCAB, size=(1, 14)))
    with torch.no_grad():
        x_emb, _ = tm.input_adapter(ids, None)
        x_off, frq = tm.input_adapter(ids[:, 6:], torch.arange(6, 14)[None])
    np.testing.assert_array_equal(x_off.numpy(), x_emb[:, 6:].numpy())
    with pytest.raises(ValueError, match="pos_offset"):
        tm(ids[:, :1], prefix_len=0, kv_cache=tm.init_cache(tm.config, 1, device="cpu"), decode=True, pos_offset=3)


# ------------------------------------------------------- the shared prefill


def _pool_with(rows_k, rows_v, page_ids, num_pages, page_size):
    pool_k = torch.zeros((num_pages, page_size, rows_k.shape[-1]), dtype=rows_k.dtype)
    pool_v = torch.zeros_like(pool_k)
    pool_k[torch.as_tensor(page_ids)] = rows_k.reshape(len(page_ids), page_size, -1)
    pool_v[torch.as_tensor(page_ids)] = rows_v.reshape(len(page_ids), page_size, -1)
    return pool_k, pool_v


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_shared_prefill_matches_jax_and_the_unshared_prefill(models, sampling):
    """The suffix prefilled over CA rows gathered from pool pages (ids in
    scrambled order): the first token, the logits and every cache equal to
    the port's unshared prefill's (1e-5) and the generator left where the
    unshared prefill leaves it (one draw); against JAX's shared prefill, the
    first token and the CA rows within 2e-5, and the logits within 2e-5 of
    JAX's full-prompt forward. Decoding on from both states gives one
    stream."""
    jm, params, tm = models
    cfg = dataclasses.replace(SAMPLERS[sampling], max_new_tokens=4)
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=(1, 20))
    skip, ps = 16, 8
    seed = 42

    token_ref, state_ref = make_prefill_fn(tm, NUM_LATENTS, cfg, device="cpu")(
        prompt, None, torch.Generator().manual_seed(seed))
    ca_ref = state_ref["cache"][0]
    pool_k, pool_v = _pool_with(ca_ref.k[0, :skip], ca_ref.v[0, :skip], [3, 1], 5, ps)
    shared = make_shared_prefill_fn(tm, NUM_LATENTS, skip, 20, cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    token, state = shared(prompt[:, skip:], pool_k, pool_v, [3, 1], gen)
    assert sorted(state) == sorted(state_ref)
    assert int(token[0]) == int(token_ref[0])
    np.testing.assert_allclose(state["logits"].numpy(), state_ref["logits"].numpy(), atol=1e-5, rtol=0)
    for c, c_ref in zip(state["cache"], state_ref["cache"]):
        assert int(c.length) == int(c_ref.length)
        np.testing.assert_allclose(c.k.numpy(), c_ref.k.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.v.numpy(), c_ref.v.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(gen.get_state(), state_ref["generator"].get_state())
    for key in ("pad_slots", "pos_shift", "done", "ca_start", "sa_start"):
        assert torch.equal(state[key], state_ref[key]), key

    jcfg = jax_generation.GenerationConfig(**dataclasses.asdict(cfg))
    jshared = jax_generation.make_shared_prefill_fn(jm, NUM_LATENTS, skip, 20, jcfg)
    jtok, jstate = jshared(params, jnp.asarray(prompt)[:, skip:], jnp.asarray(pool_k.numpy()),
                           jnp.asarray(pool_v.numpy()), jnp.asarray([3, 1], jnp.int32), jax.random.PRNGKey(seed))
    if sampling == "greedy":  # the draws differ by contract (one uniform a token against a key split)
        assert int(jtok[0]) == int(token[0])
    for c, jc in zip(state["cache"], jstate["cache"]):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), atol=2e-5, rtol=0)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), atol=2e-5, rtol=0)
    jlogits = jm.apply(params, jnp.asarray(prompt), prefix_len=20 - NUM_LATENTS).logits[:, -1]
    np.testing.assert_allclose(state["logits"].numpy(), np.asarray(jlogits), atol=2e-5, rtol=0)

    _, step = make_decode_fns(tm, NUM_LATENTS, cfg, device="cpu")
    got, want = [int(token[0])], [int(token_ref[0])]
    for _ in range(cfg.max_new_tokens - 1):
        got.append(int(step(state)[1][0]))
        want.append(int(step(state_ref)[1][0]))
    assert got == want


def test_shared_prefill_refuses_what_jax_refuses(models):
    """A match reaching into the latent region, a skip of no token, and a
    page run that does not cover the skipped tokens raise, as in JAX."""
    _, _, tm = models
    cfg = GenerationConfig(max_new_tokens=2)
    with pytest.raises(ValueError, match="latent"):
        make_shared_prefill_fn(tm, NUM_LATENTS, 16, 18, cfg, device="cpu")
    with pytest.raises(ValueError, match="skip_tokens"):
        make_shared_prefill_fn(tm, NUM_LATENTS, 0, 18, cfg, device="cpu")
    fn = make_shared_prefill_fn(tm, NUM_LATENTS, 8, 18, cfg, device="cpu")
    pool = torch.zeros((4, 4, CONFIG["num_channels"]))
    with pytest.raises(ValueError, match="whole pages"):
        fn(np.zeros((1, 10), np.int64), pool, pool, [1])
    with pytest.raises(ValueError, match="suffix is"):
        fn(np.zeros((1, 9), np.int64), pool, pool, [1, 2])


# ------------------------------------------------------ the engine shares


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_engine_sharing_token_exact_and_isolated(models, sampling):
    """Six requests over one 8-token document: every stream equals the
    port's sequential stream (and, greedy, the JAX engine's, which shares
    the same way: the same hits), the publisher retires before its sharers,
    and everything drains clean: refcounts balanced, the index empty."""
    jm, params, tm = models
    base = SAMPLERS[sampling]
    engine = _engine(tm, base)
    specs = _shared_specs(WorkloadSpec, 6)
    records = engine.run_closed(specs, concurrency=6)
    assert [r.outcome for r in records] == ["ok"] * 6
    assert engine._n_prefix_hits >= 1
    for spec in specs:
        assert engine.served_tokens[spec.index] == _sequential(tm, spec, base), spec.index
    assert engine.books()["balanced"] and engine.audit() == [] and engine.sharing_audit() == []
    assert engine.ca_alloc.pages_used == 0 and engine.ca_alloc._rc == {} and engine.prefix_index.pages() == ()
    if sampling == "greedy":
        jfe = _jax_engine(jm, params)
        jfe.run_closed(_shared_specs(JaxWorkloadSpec, 6), concurrency=6)
        assert jfe._n_prefix_hits == engine._n_prefix_hits
        assert jfe._n_prefix_pages_shared == engine._n_prefix_pages_shared
        assert {i: list(map(int, s)) for i, s in jfe.served_tokens.items()} == engine.served_tokens


def test_sharing_counters_and_events(models, tmp_path):
    """The hits and pages counters (tenant-labelled too), one valid
    ``serve.prefix_hit`` row a shared join, and a disabled index: no hit."""
    from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events

    _, _, tm = models
    specs = [dataclasses.replace(s, tenant="t1") for s in _shared_specs(WorkloadSpec, 4)]
    engine = _engine(tm, events=EventLog(str(tmp_path), main_process=True))
    engine.run_closed(specs, concurrency=4)
    rows = [e for e in merged_events(str(tmp_path)) if e["event"] == "serve.prefix_hit"]
    assert validate_events(str(tmp_path), warnings_out=[]) == []
    assert len(rows) == engine._n_prefix_hits >= 1
    assert all(r["pages_matched"] == 1 and r["tokens_skipped"] == 8 and r["tenant"] == "t1" for r in rows)
    hits = engine.registry.counter("serve_prefix_hits_total")
    assert hits.value == len(rows) and hits.labels(tenant="t1").value == len(rows)
    assert engine.registry.counter("serve_prefix_pages_shared").value == engine._n_prefix_pages_shared

    off = serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu",
                                 engine_config=serving.EngineConfig(slots=4, page_size=8, max_ca_tokens=24,
                                                                    max_sa_tokens=16, prefix_sharing=False))
    off.run_closed(specs, concurrency=4)
    assert off._n_prefix_hits == 0 and len(off.prefix_index) == 0
    assert off.served_tokens == engine.served_tokens


def test_recovery_rebuilds_refcounts(models, tmp_path):
    """A crash mid-flight with shared-prefix requests live and queued: the
    second engine's recovery re-admits them into a fresh allocator and
    index, the replays and joins rebuild the refcounts, the re-served
    requests share again, and the streams are the sequential ones."""
    _, _, tm = models
    jpath = str(tmp_path / "journal.jsonl")
    specs = _shared_specs(WorkloadSpec, 6, seed=23)
    fe1 = _engine(tm, max_sa_tokens=8, journal=jpath, injector=serving.FaultInjector().crash_at(2, 1))
    with pytest.raises(serving.EngineCrash):
        fe1.run_closed(specs, concurrency=6)
    journal = serving.RequestJournal(jpath)
    owed = journal.pending()
    assert len(owed) >= 2
    fe2 = _engine(tm, max_sa_tokens=8)
    assert fe2.recover(journal)["recovered"] == len(owed)
    fe2.pump()
    books = fe2.books()
    assert books["balanced"] and books["parked"] == 0, books
    assert fe2.audit() == [] and fe2.sharing_audit() == []
    assert fe2.ca_alloc.pages_used == 0 and fe2.ca_alloc._rc == {} and fe2.prefix_index.pages() == ()
    assert fe2._n_prefix_hits >= 1
    served = {**fe1.served_tokens, **fe2.served_tokens}
    for spec in specs:
        assert served[spec.index] == _sequential(tm, spec), spec.index


def test_a_prompt_is_hashed_once_and_only_when_a_run_could_match(models):
    """Requests that share nothing cost no prompt hash and no index node
    (each run is withdrawn at its retire, unread); shared-prefix requests
    under page backpressure (half the pool: joins retried while pages are
    short) hash each prompt once however often the join is tried. The
    streams are the sequential ones either way."""
    _, _, tm = models
    for specs, hits in ((WorkloadSpec(seed=31, prompt_lens=(16,), max_new_tokens=(3, 4)).draw(6, VOCAB), False),
                        (_shared_specs(WorkloadSpec, 6), True)):
        engine = serving.EngineFrontEnd(
            tm, num_latents=NUM_LATENTS, device="cpu",
            engine_config=serving.EngineConfig(slots=4, page_size=8, max_ca_tokens=24, max_sa_tokens=16,
                                               pool_headroom=0.5 if hits else 1.0))
        chunks, tries = [], []
        chunks_fn, join = engine.prefix_index.chunks, engine._try_join
        engine.prefix_index.chunks = lambda tokens: chunks.append(len(tokens)) or chunks_fn(tokens)
        engine._try_join = lambda ticket, slot: tries.append(ticket.record.index) or join(ticket, slot)
        records = engine.run_closed(specs, concurrency=6)
        assert [r.outcome for r in records] == ["ok"] * 6
        for spec in specs:
            assert engine.served_tokens[spec.index] == _sequential(tm, spec), spec.index
        assert engine.books()["balanced"] and engine.sharing_audit() == [] and engine.prefix_index.pages() == ()
        if hits:
            assert engine._n_prefix_hits >= 1 and len(tries) > len(set(tries))
            assert 1 <= len(chunks) <= len(specs)
        else:
            assert engine._n_prefix_hits == 0 and chunks == []


def test_a_poisoned_join_publishes_nothing(models):
    """A request prefilled on poisoned weights lands in the index nowhere:
    the requests that join beside it over the same document prefill (or
    share a clean publisher's pages) and serve their sequential streams."""
    _, _, tm = models
    specs = _shared_specs(WorkloadSpec, 6)
    engine = _engine(tm, injector=serving.FaultInjector().poison_at(specs[0].index))
    published = []
    publish = engine._publish_prefix
    engine._publish_prefix = lambda ticket, *a, **k: published.append(ticket.record.index) or publish(ticket, *a, **k)
    records = engine.run_closed(specs, concurrency=6)
    assert [r.outcome for r in records] == ["ok"] * 6
    assert specs[0].index not in published and published
    assert engine._n_prefix_hits >= 1
    for spec in specs[1:]:
        assert engine.served_tokens[spec.index] == _sequential(tm, spec), spec.index
    assert engine.books()["balanced"] and engine.sharing_audit() == [] and engine.prefix_index.pages() == ()


def test_cow_fork_copies_the_page_in_place(models):
    """A write into a shared append page forks the grant and copies the
    page's pool rows into the fresh page IN PLACE: the co-owner's bytes stay,
    the appender owns an identical copy, no pool tensor is rebound (the
    captured step's addresses hold). An unshared append page passes through;
    a dry pool answers None with nothing changed."""
    _, _, tm = models
    engine = _engine(tm)
    a = engine.ca_alloc
    pool = engine._state["cache"][0]
    addresses = (pool.k.data_ptr(), pool.v.data_ptr())
    g1 = a.alloc_tokens(16)
    g2 = a.alloc_tokens_shared(24, g1.pages)
    tail = g2.pages[1]
    pool.k[tail] = 7.0
    pool.v[tail] = -3.0
    forked = engine._fork_shared_append_page(g2, 12)
    fresh = forked.pages[1]
    assert forked.grant_id == g2.grant_id and fresh != tail and forked.shared_pages == (g2.pages[0],)
    pool = engine._state["cache"][0]
    assert (pool.k.data_ptr(), pool.v.data_ptr()) == addresses
    assert bool((pool.k[fresh] == 7.0).all()) and bool((pool.v[fresh] == -3.0).all())
    assert bool((pool.k[tail] == 7.0).all())
    assert a.refcount(tail) == 1 and a.holders(tail) == [g1.grant_id] and a.refcount(fresh) == 1
    assert engine._fork_shared_append_page(forked, 20) is forked
    hog = a.alloc_tokens(a.pages_free * 8)
    k_before = pool.k.clone()
    assert engine._fork_shared_append_page(forked, 4) is None
    assert torch.equal(pool.k, k_before) and a.audit() == []
    for g in (hog, forked, g1):
        a.free(g)
    assert a.pages_used == 0 and a._rc == {}


# ------------------------------------------- K2 over a filled contiguous cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("padded", [False, True], ids=["no_pad", "pad"])
def test_span_over_a_filled_cache_takes_k2_and_matches_dense(dtype, padded, monkeypatch):
    """Six queries appended to a cache that holds 10 rows: the route runs
    K2's wrapper (its plain version on the CPU) over the 16 filled slots,
    never the dense path, and equals the dense path over the slots with the
    causal mask right-aligned."""
    from perceiver_io_tpu_torch.core import attention

    gen = torch.Generator().manual_seed(0)
    mha = MultiHeadAttention(4, 32, 32, causal_attention=True, dtype=dtype)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    cache = init_kv_cache(2, 24, 32, 32, dtype, "cpu")
    cache.k[:, :10] = torch.randn(2, 10, 32, generator=gen).to(dtype)
    cache.v[:, :10] = torch.randn(2, 10, 32, generator=gen).to(dtype)
    cache.length = 10
    x = torch.randn(2, 6, 32, generator=gen).to(dtype)
    rope = torch.randn(2, 6, 8, generator=gen)
    pad = None
    if padded:
        pad = torch.zeros(2, 24, dtype=torch.bool)
        pad[1, :3] = True
    calls = {"k2": 0, "dense": 0}
    k2, dense = attention.flash_attention_packed, MultiHeadAttention._dense

    def counted_k2(*args, **kwargs):
        calls["k2"] += 1
        return k2(*args, **kwargs)

    def counted_dense(self, *args, **kwargs):
        calls["dense"] += 1
        return dense(self, *args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_packed", counted_k2)
    monkeypatch.setattr(MultiHeadAttention, "_dense", counted_dense)
    with torch.no_grad():
        out = mha(x, x, pad_mask=pad, rope_q=rope, rope_k=rope, kv_cache=cache)
    assert calls == {"k2": 1, "dense": 0}
    assert out.kv_cache.length == 16
    with torch.no_grad():
        q = mha._proj(mha.q_proj, x)
        masked = (torch.arange(24) >= 16)[None, None, :] | MultiHeadAttention._causal(6, 24, 16, "cpu")
        if pad is not None:
            masked = masked | pad[:, None, :]
        want = mha._proj(mha.o_proj, dense(mha, q, out.kv_cache.k, out.kv_cache.v, rope, masked))
    got, want = out.last_hidden_state.double(), want.double()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    else:
        assert float((got - want).norm() / want.norm()) < 1e-2


def test_span_over_a_filled_cache_takes_the_dense_path_for_wide_heads(monkeypatch):
    """Head dims K2 cannot take (here 160) keep the dense path."""
    mha = MultiHeadAttention(2, 320, 320, causal_attention=True)
    cache = init_kv_cache(1, 12, 320, 320, torch.float32, "cpu")
    cache.length = 4
    calls = []
    dense = MultiHeadAttention._dense
    monkeypatch.setattr(MultiHeadAttention, "_dense", lambda self, *a, **k: calls.append(1) or dense(self, *a, **k))
    with torch.no_grad():
        mha(torch.randn(1, 3, 320), torch.randn(1, 3, 320), kv_cache=cache)
    assert calls == [1]
