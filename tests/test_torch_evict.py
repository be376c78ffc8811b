"""The port's page-pressure eviction and journal recovery on the CPU (the
plain kernel versions), held to the JAX package.

Eviction parks the least-progressed slot (pages reclaimed) and resumes it by
prefill replay over prompt + served tokens, its generator advanced one draw
a served token when sampling (``generation.advance_generator``, the port's
``advance_rng_chain``). The write-ahead request journal
(``serving.journal``, a copy of JAX's) survives an ``EngineCrash`` and a
fresh engine's ``recover()`` re-admits every non-terminal request, the books
closing across the restart. Held exactly: greedy streams, books and
eviction counts to JAX's engine on the same specs; sampled streams to the
port's own uninterrupted sequential stream (the draws differ from JAX's by
contract); a journal the JAX engine wrote, recovered by the port's engine,
to JAX's greedy streams; both journals' books and audits on the same
records."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.events import EventLog as JaxEventLog
from perceiver_io_tpu.obs.loadgen import WorkloadSpec as JaxWorkloadSpec
from perceiver_io_tpu.serving import journal as jax_journal
from perceiver_io_tpu_torch import generation, serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.generation import GenerationConfig, advance_generator, make_decode_fns
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
from perceiver_io_tpu_torch.obs.loadgen import RequestSpec, WorkloadSpec
from perceiver_io_tpu_torch.serving import journal as torch_journal

NUM_LATENTS, VOCAB = 4, 64
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
# budgets <= 4 keep num_latents + budget within max_latents (8): the
# no-slide geometry eviction and the journal ask for
ENGINE = dict(slots=4, page_size=8, max_ca_tokens=16, max_sa_tokens=8)
SAMPLERS = {"greedy": GenerationConfig(), "temperature": GenerationConfig(do_sample=True, temperature=0.8, top_k=10)}


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _engine(tm, base=None, *, headroom=1.0, eviction=False, **kw):
    return serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, base_config=base, device="cpu",
                                  engine_config=serving.EngineConfig(**ENGINE, pool_headroom=headroom,
                                                                     eviction=eviction), **kw)


def _jax_engine(jm, params, *, headroom=1.0, eviction=False, **kw):
    return jax_serving.EngineFrontEnd(jm, params, num_latents=NUM_LATENTS,
                                      engine_config=jax_serving.EngineConfig(**ENGINE, pool_headroom=headroom,
                                                                             eviction=eviction), **kw)


def _specs(n, seed=13, workload=WorkloadSpec):
    return workload(seed=seed, prompt_lens=(8, 12), max_new_tokens=(3, 4)).draw(n, VOCAB)


def _sequential(tm, spec, base=None):
    cfg = dataclasses.replace(base or GenerationConfig(), max_new_tokens=spec.max_new_tokens)
    prefill, step = make_decode_fns(tm, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec.input_ids, None, torch.Generator().manual_seed(spec.rng_seed))
    out = [int(token[0])]
    for _ in range(spec.max_new_tokens - 1):
        state, token = step(state)
        out.append(int(token[0]))
    return out


def _streams(fe):
    return {i: [int(t) for t in s] for i, s in fe.served_tokens.items()}


def _submitted(j, spec):
    j.append("submitted", spec.index, prompt_len=spec.prompt_len, max_new_tokens=spec.max_new_tokens,
             input_ids=np.asarray(spec.input_ids).tolist(), rng_seed=spec.rng_seed, deadline_s=None)


# ------------------------------------------------------- the generator's law


def test_advance_generator_law():
    """A generator's position is its count of sampled tokens: advanced past
    n tokens, its next draw is the (n+1)-th single draw of a fresh
    generator of the same seed; greedy decoding draws nothing."""
    sample = SAMPLERS["temperature"]
    singles = [float(torch.rand((1,), generator=g)) for g in [torch.Generator().manual_seed(7)] for _ in range(40)]
    for n in (0, 1, 5, 17, 39):
        g = advance_generator(torch.Generator().manual_seed(7), n, sample)
        assert float(torch.rand((1,), generator=g)) == singles[n]
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    assert advance_generator(g, 25, GenerationConfig()) is g and torch.equal(g.get_state(), state)


def test_resume_replay_prefill_is_the_uninterrupted_step(models):
    """The seam in one request: after n served tokens, the prefill over
    prompt + those tokens with num_latents + n latents and the generator
    advanced n draws samples token n + 1 of the uninterrupted stream, its
    logits within 1e-5 of the uninterrupted step's."""
    _, _, tm = models
    spec = _specs(1, seed=5)[0]
    cfg = dataclasses.replace(SAMPLERS["temperature"], max_new_tokens=spec.max_new_tokens)
    prefill, step = make_decode_fns(tm, NUM_LATENTS, cfg, device="cpu")
    token, state = prefill(spec.input_ids, None, torch.Generator().manual_seed(spec.rng_seed))
    stream, logits = [int(token[0])], [state["logits"].clone()]
    for _ in range(spec.max_new_tokens - 1):
        state, token = step(state)
        stream.append(int(token[0]))
        logits.append(state["logits"].clone())
    for n in range(1, spec.max_new_tokens):
        replay = generation.make_prefill_fn(tm, NUM_LATENTS + n, dataclasses.replace(cfg, max_new_tokens=1),
                                            device="cpu")
        ids = np.concatenate([np.asarray(spec.input_ids), np.asarray([stream[:n]])], axis=1)
        gen = advance_generator(torch.Generator().manual_seed(spec.rng_seed), n, cfg)
        token, rstate = replay(ids, None, gen)
        assert int(token[0]) == stream[n]
        np.testing.assert_allclose(rstate["logits"].numpy(), logits[n].numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ eviction


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_eviction_resume_token_exact(models, sampling):
    """A half-size pool forces evictions; every request serves ``ok`` and
    every stream (the evicted and resumed ones too) equals the port's
    sequential stream; greedy, the streams and the books (evictions and
    resumes included) equal the JAX engine's on the same specs. The pages
    come back."""
    jm, params, tm = models
    base = SAMPLERS[sampling]
    fe = _engine(tm, base, headroom=0.5, eviction=True)
    records = fe.run_closed(_specs(8), concurrency=8)
    books = fe.books()
    assert books["evictions"] >= 1 and books["evictions"] == books["resumes"], books
    assert books["ok"] == 8 and books["shed"] == 0 and books["balanced"], books
    assert all(r.outcome == "ok" for r in records) and fe.audit() == []
    assert fe.ca_alloc.pages_used == 0 and fe.sa_alloc.pages_used == 0
    assert fe.ca_alloc.audit() == [] and fe.sa_alloc.audit() == []
    for spec in _specs(8):
        assert fe.served_tokens[spec.index] == _sequential(tm, spec, base), spec.index
    if sampling == "greedy":
        jfe = _jax_engine(jm, params, headroom=0.5, eviction=True)
        jfe.run_closed(_specs(8, workload=JaxWorkloadSpec), concurrency=8)
        assert _streams(jfe) == _streams(fe)
        assert jfe.books() == books
        assert [(r.index, r.outcome, r.tokens_out, r.attempts) for r in jfe.records] == \
            [(r.index, r.outcome, r.tokens_out, r.attempts) for r in fe.records]


def test_eviction_disabled_is_pure_backpressure(models):
    _, _, tm = models
    fe = _engine(tm, headroom=0.5, eviction=False)
    fe.run_closed(_specs(8), concurrency=8)
    books = fe.books()
    assert books["evictions"] == 0 and books["resumes"] == 0, books
    assert books["ok"] == 8 and books["balanced"], books


def test_eviction_and_journal_require_no_slide_geometry(models, tmp_path):
    """Eviction and a journal need the no-slide window at construction, and
    ``recover`` checks it again (it can adopt a journal onto an engine built
    without one)."""
    _, _, tm = models
    sliding = dict(slots=4, page_size=8, max_ca_tokens=16, max_sa_tokens=16)
    with pytest.raises(ValueError, match="never slide the window"):
        serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu",
                               engine_config=serving.EngineConfig(**sliding, eviction=True))
    sliding = dict(slots=2, page_size=8, max_ca_tokens=32, max_sa_tokens=8)
    with pytest.raises(ValueError, match="never slide"):
        serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu",
                               engine_config=serving.EngineConfig(**sliding), journal=str(tmp_path / "j.jsonl"))
    fe = serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu",
                                engine_config=serving.EngineConfig(**sliding))
    with pytest.raises(ValueError, match="never slide"):
        fe.recover(str(tmp_path / "j2.jsonl"))


def test_parked_population_in_books_identity(models):
    """Mid-run an evicted request sits in ``parked`` and ``submitted ==
    terminal + queued + in_flight + parked`` holds at every step; the
    parked-depth gauge's high-water mark saw it."""
    _, _, tm = models
    fe = _engine(tm, headroom=0.5, eviction=True)
    seen, step = [], fe._engine_step

    def stepped():
        step()
        b = fe.books()
        assert b["balanced"], b
        seen.append(b["parked"])

    fe._engine_step = stepped
    fe.run_closed(_specs(8), concurrency=8)
    assert max(seen) >= 1 and fe.books()["parked"] == 0
    assert fe.registry.gauge("serve_parked_depth").peak >= 1
    assert fe.registry.counter("serve_evictions_total").value == fe.books()["evictions"]
    assert fe.registry.counter("serve_resumes_total").value == fe.books()["resumes"]


def test_cancel_reaches_parked_request(models):
    """``cancel`` on a parked request books it ``cancelled`` when the resume
    loop reaches it, without a replay."""
    _, _, tm = models
    fe = _engine(tm, headroom=0.5, eviction=True)
    cancelled, step = [], fe._engine_step

    def stepped():
        step()
        if not cancelled and fe._parked:
            idx = fe._parked[0].ticket.record.index
            assert fe.cancel(idx) is True
            cancelled.append(idx)

    fe._engine_step = stepped
    records = fe.run_closed(_specs(8), concurrency=8)
    assert cancelled
    books = fe.books()
    assert books["balanced"] and books["parked"] == 0 and books["cancelled"] == 1 and books["ok"] == 7, books
    assert next(r for r in records if r.index == cancelled[0]).outcome == "cancelled"
    assert fe.audit(expect_drained=True) == []


def test_eviction_events_validate(models, tmp_path):
    """One ``serve.evict`` row an eviction and one ``serve.resume`` row a
    resume (span-attributed), every row valid, the same kinds and counts as
    the JAX engine writes for the same run."""
    jm, params, tm = models
    fe = _engine(tm, headroom=0.5, eviction=True, events=EventLog(str(tmp_path / "torch"), main_process=True))
    fe.run_closed(_specs(8), concurrency=8)
    jfe = _jax_engine(jm, params, headroom=0.5, eviction=True,
                      events=JaxEventLog(str(tmp_path / "jax"), main_process=True))
    jfe.run_closed(_specs(8, workload=JaxWorkloadSpec), concurrency=8)
    assert validate_events(str(tmp_path / "torch"), warnings_out=[]) == []
    rows = merged_events(str(tmp_path / "torch"))
    jrows = merged_events(str(tmp_path / "jax"))
    for kind, n in (("serve.evict", fe.books()["evictions"]), ("serve.resume", fe.books()["resumes"])):
        ours = [(e["request_index"], e["tokens_out"]) for e in rows if e["event"] == kind]
        assert len(ours) == n >= 1 and all("span_id" in e for e in rows if e["event"] == kind)
        assert ours == [(e["request_index"], e["tokens_out"]) for e in jrows if e["event"] == kind]


def test_prefill_cache_is_bounded_and_builds_no_step(models, monkeypatch):
    """The prefill cache is LRU-bounded (a hit moves to the tail), keyed by
    (budget, latents), and builds prefills alone: no decode step beside
    them."""
    _, _, tm = models
    fe = _engine(tm)
    monkeypatch.setattr(type(fe), "_PREFILL_CACHE_MAX", 2)

    def no_step(*args, **kwargs):
        raise AssertionError("a decode step was built for a prefill")

    monkeypatch.setattr(generation, "_eager_step", no_step)
    monkeypatch.setattr(generation, "_GraphedStep", no_step)
    fe._prefill_fns.clear()
    a = fe._prefill_for(2)
    fe._prefill_for(3)
    assert fe._prefill_for(2) is a
    fe._prefill_for(4)
    assert list(fe._prefill_fns) == [(2, NUM_LATENTS), (4, NUM_LATENTS)]
    fe._prefill_for(2, NUM_LATENTS + 1)
    assert list(fe._prefill_fns) == [(4, NUM_LATENTS), (2, NUM_LATENTS + 1)]
    shared = fe._shared_prefill_for(8, 16, 3)
    assert fe._shared_prefill_for(8, 16, 3) is shared and len(fe._shared_prefill_fns) == 1


# ------------------------------------------------------------ crash recovery


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_crash_recovery_token_exact_books_balanced(models, tmp_path, sampling):
    """The engine dies mid-decode (``EngineCrash``: no seam books it); a
    second engine recovers every non-terminal request from the journal and
    serves it token-exactly; the journal's books balance across the
    restart, and its replayed streams are the sequential ones."""
    _, _, tm = models
    base = SAMPLERS[sampling]
    jpath = str(tmp_path / "journal.jsonl")
    specs = _specs(6)
    fe1 = _engine(tm, base, journal=jpath, injector=serving.FaultInjector().crash_at(2, 1))
    with pytest.raises(serving.EngineCrash):
        fe1.run_closed(specs, concurrency=6)
    books1 = fe1.books()
    assert books1["terminal"] < books1["submitted"], books1
    journal = serving.RequestJournal(jpath)
    owed = journal.pending()
    assert len(owed) == books1["submitted"] - books1["terminal"] and any(e.tokens for e in owed)
    fe2 = _engine(tm, base)
    info = fe2.recover(journal)
    assert info["recovered"] == len(owed) and info["parked"] >= 1
    fe2.pump()
    books2 = fe2.books()
    assert books2["balanced"] and books2["parked"] == 0 and books2["recovered"] == len(owed), books2
    assert fe2.audit() == []
    jb = journal.books()
    assert jb["balanced"] and jb["pending"] == 0 and jb["submitted"] == 6 and jb["outcomes"] == {"ok": 6}, jb
    assert journal.audit() == []
    replayed = {i: e.tokens for i, e in journal.replay().items()}
    served = {**fe1.served_tokens, **fe2.served_tokens}
    for spec in specs:
        want = _sequential(tm, spec, base)
        assert served[spec.index] == want and replayed[spec.index] == want, spec.index


def test_jax_journal_recovered_by_the_port(models, tmp_path):
    """A journal the JAX engine wrote before it crashed, recovered by the
    port's engine: every request it owed is re-admitted (parked or queued),
    the journal's books close over both engines, and its replayed streams
    are the JAX engine's uninterrupted greedy streams."""
    jm, params, tm = models
    jpath = str(tmp_path / "journal.jsonl")
    jfe = _jax_engine(jm, params, journal=jpath, injector=jax_serving.FaultInjector().crash_at(2, 1))
    with pytest.raises(jax_serving.EngineCrash):
        jfe.run_closed(_specs(6, workload=JaxWorkloadSpec), concurrency=6)
    owed = jax_journal.RequestJournal(jpath).pending()
    assert any(e.tokens for e in owed)
    fe = _engine(tm)
    info = fe.recover(jpath)
    assert info["recovered"] == len(owed) and info["parked"] >= 1, info
    fe.pump()
    assert fe.books()["balanced"] and fe.audit() == []
    jb = jax_journal.RequestJournal(jpath).books()
    assert jb["balanced"] and jb["outcomes"] == {"ok": 6}, jb
    uninterrupted = _jax_engine(jm, params)
    uninterrupted.run_closed(_specs(6, workload=JaxWorkloadSpec), concurrency=6)
    replayed = {i: e.tokens for i, e in serving.RequestJournal(jpath).replay().items()}
    assert replayed == _streams(uninterrupted)


def test_recover_books_complete_stream_without_replay(models, tmp_path):
    """Progress that covers the whole budget (the crash fell between the
    last token and its retire) books ``ok`` at recover time: nothing
    decoded, nothing parked."""
    _, _, tm = models
    spec = _specs(1)[0]
    j = serving.RequestJournal(str(tmp_path / "done.jsonl"))
    _submitted(j, spec)
    j.append("admitted", spec.index)
    full = _sequential(tm, spec)
    j.append("progress", spec.index, tokens=full)
    fe = _engine(tm)
    assert fe.recover(j) == {"recovered": 1, "parked": 0, "queued": 0, "already_complete": 1, "shed": 0,
                             "skipped": 0}
    assert fe.books()["ok"] == 1 and fe.books()["balanced"] and j.books()["balanced"]
    assert fe.served_tokens[spec.index] == full


def test_recover_is_idempotent_on_request_index(models, tmp_path):
    """A second pass before the drain skips every index the engine carries;
    a third after the drain is a no-op; the streams serve once, exactly."""
    _, _, tm = models
    jpath = str(tmp_path / "journal.jsonl")
    specs = _specs(6)
    fe1 = _engine(tm, journal=jpath, injector=serving.FaultInjector().crash_at(2, 1))
    with pytest.raises(serving.EngineCrash):
        fe1.run_closed(specs, concurrency=6)
    journal = serving.RequestJournal(jpath)
    owed = journal.pending()
    fe2 = _engine(tm)
    first = fe2.recover(journal)
    assert first["recovered"] == len(owed) and first["skipped"] == 0
    submitted = fe2.books()["submitted"]
    still = journal.pending()
    second = fe2.recover(journal)
    assert second == {"recovered": 0, "parked": first["parked"], "queued": first["queued"], "already_complete": 0,
                      "shed": 0, "skipped": len(still)} and second["skipped"] >= 2
    assert fe2.books()["submitted"] == submitted
    fe2.pump()
    assert fe2.books()["balanced"] and fe2.books()["ok"] == len(owed)
    assert fe2.recover(journal) == {"recovered": 0, "parked": 0, "queued": 0, "already_complete": 0, "shed": 0,
                                    "skipped": 0}
    jb = journal.books()
    assert jb["balanced"] and jb["submitted"] == 6 and jb["outcomes"] == {"ok": 6}, jb
    served = {**fe1.served_tokens, **fe2.served_tokens}
    assert all(served[s.index] == _sequential(tm, s) for s in specs)


def test_survivor_recovery_hands_off_into_its_own_journal(models, tmp_path):
    """The failover shape: a survivor with its own journal re-journals each
    adopted request there and closes it in the dead journal with a
    ``handoff`` record; both journals balance after the drain, as JAX's
    engine leaves them on the same dead journal."""
    jm, params, tm = models
    summaries, books = {}, {}
    for side in ("jax", "torch"):
        dead = str(tmp_path / side / "dead.jsonl")
        own = str(tmp_path / side / "own.jsonl")
        if side == "jax":
            fe1 = _jax_engine(jm, params, journal=dead, injector=jax_serving.FaultInjector().crash_at(2, 1))
            specs, crash, mod = _specs(6, workload=JaxWorkloadSpec), jax_serving.EngineCrash, jax_journal
            fe2 = _jax_engine(jm, params, journal=own)
        else:
            fe1 = _engine(tm, journal=dead, injector=serving.FaultInjector().crash_at(2, 1))
            specs, crash, mod = _specs(6), serving.EngineCrash, torch_journal
            fe2 = _engine(tm, journal=own)
        with pytest.raises(crash):
            fe1.run_closed(specs, concurrency=6)
        summaries[side] = fe2.recover(dead, handoff_id="survivor")
        fe2.pump()
        books[side] = (mod.RequestJournal(dead).books(), mod.RequestJournal(own).books(),
                       mod.RequestJournal(dead).audit(), mod.RequestJournal(own).audit(), fe2.books())
        assert books[side][0]["balanced"] and books[side][0]["handed_off"] == summaries[side]["recovered"]
        assert books[side][1]["balanced"] and books[side][2:4] == ([], [])
    assert summaries["torch"] == summaries["jax"]
    assert books["torch"] == books["jax"]


def test_recover_skips_torn_submitted_entry(models, tmp_path):
    """An entry whose ``submitted`` record was torn has no spec to rebuild:
    ``pending()`` leaves it out, ``recover()`` re-admits the intact one, and
    the journal's audit names the loss."""
    _, _, tm = models
    jpath = str(tmp_path / "torn.jsonl")
    specs = _specs(2)
    j = serving.RequestJournal(jpath)
    for spec in specs:
        _submitted(j, spec)
        j.append("admitted", spec.index)
    j.append("progress", specs[1].index, tokens=[5])
    with open(jpath) as f:
        lines = f.readlines()
    lines[0] = lines[0][: len(lines[0]) // 2] + "\n"
    with open(jpath, "w") as f:
        f.writelines(lines)
    j2 = serving.RequestJournal(jpath)
    assert [e.index for e in j2.pending()] == [specs[1].index]
    assert any("without a parseable submitted record" in p for p in j2.audit())
    fe = _engine(tm)
    info = fe.recover(j2)
    assert info["recovered"] == 1 and info["parked"] == 1, info
    fe.pump()
    assert fe.books()["ok"] == 1 and fe.books()["balanced"]


def test_recover_sheds_unfit_request_instead_of_spinning(models, tmp_path):
    """A journaled request this engine can never fit sheds
    ``kv_pages_exhausted`` at recover time; the other serves."""
    _, _, tm = models
    j = serving.RequestJournal(str(tmp_path / "journal.jsonl"))
    j.append("submitted", 999, prompt_len=14, max_new_tokens=4, input_ids=[list(range(14))], rng_seed=7,
             deadline_s=None)
    j.append("admitted", 999)
    spec = _specs(1)[0]
    _submitted(j, spec)
    j.append("admitted", spec.index)
    fe = _engine(tm)
    info = fe.recover(j)
    assert info["shed"] == 1 and info["recovered"] == 1, info
    fe.pump()
    books = fe.books()
    assert books["balanced"] and books["shed"] == 1 and books["ok"] == 1, books
    assert j.books()["outcomes"] == {"shed": 1, "ok": 1} and j.books()["balanced"]
    shed = next(r for r in fe.records if r.index == 999)
    assert shed.outcome == "shed" and shed.shed_reason == "kv_pages_exhausted"


def test_recover_span_carries_request_identity(models, tmp_path):
    """The ``serve.recover`` span of a request recovered mid-decode carries
    the request_id its resume span and terminal ``request`` row carry, and
    its ``request_index``; every row validates."""
    _, _, tm = models
    jpath = str(tmp_path / "journal.jsonl")
    fe1 = _engine(tm, journal=jpath, injector=serving.FaultInjector().crash_at(1, 1))
    with pytest.raises(serving.EngineCrash):
        fe1.run_closed(_specs(4), concurrency=4)
    run_dir = str(tmp_path / "run")
    events = EventLog(run_dir, main_process=True)
    fe2 = _engine(tm, events=events)
    fe2.recover(jpath)
    fe2.pump()
    events.close()
    assert validate_events(run_dir, warnings_out=[]) == []
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    spans = {r["span_id"]: r for r in rows if r.get("event") == "span"}
    recovers = [r for r in rows if r.get("event") == "serve.recover" and r.get("tokens_resumed", 0) > 0]
    resumes = {r["request_index"]: r for r in rows if r.get("event") == "serve.resume"}
    request_ids = {r.get("request_id") for r in rows if r.get("event") == "request"}
    assert recovers
    for row in recovers:
        span = spans[row["span_id"]]
        assert span["attrs"]["request_index"] == row["request_index"]
        rid = span["attrs"]["request_id"]
        assert spans[resumes[row["request_index"]]["span_id"]]["attrs"]["request_id"] == rid
        assert rid in request_ids


# ----------------------------------------------------------------- journal


@pytest.mark.parametrize("mod", [jax_journal, torch_journal], ids=["jax", "torch"])
def test_journal_replay_books_and_torn_lines(mod, tmp_path):
    """Replay folds progress records in order, ``pending`` is submitted
    minus terminal, books balance once every submission ended, a torn tail
    is read around and a torn mid-file line is an audit problem; both
    packages' journals give the same answers on the same file."""
    jpath = str(tmp_path / "j.jsonl")
    j = mod.RequestJournal(jpath)
    j.append("submitted", 0, prompt_len=4, max_new_tokens=3, input_ids=[[1, 2, 3, 4]], rng_seed=7, deadline_s=None)
    j.append("admitted", 0)
    j.append("progress", 0, tokens=[5])
    j.append("progress", 0, tokens=[6, 7])
    j.append("submitted", 1, prompt_len=4, max_new_tokens=2, input_ids=[[1, 2, 3, 4]], rng_seed=8, deadline_s=1.5)
    state = j.replay()
    assert state[0].tokens == [5, 6, 7] and state[1].tokens == []
    assert [e.index for e in j.pending()] == [0, 1]
    b = j.books()
    assert b["submitted"] == 2 and b["terminal"] == 0 and not b["balanced"] and len(j.audit()) == 2
    j.append("terminal", 0, outcome="ok", tokens_out=3)
    j.append("terminal", 1, outcome="cancelled", tokens_out=0)
    assert j.books()["balanced"] and j.books()["outcomes"] == {"ok": 1, "cancelled": 1} and j.audit() == []
    spec = j.replay()[1].spec()
    assert (spec.index, spec.prompt_len, spec.max_new_tokens, spec.rng_seed) == (1, 4, 2, 8)
    assert spec.input_ids.tolist() == [[1, 2, 3, 4]]
    with open(jpath, "a") as f:
        f.write('{"kind": "progress", "index": 0, "tok')
    assert j.books()["balanced"]
    lines = open(jpath).read().splitlines()
    lines.insert(2, '{"torn mid-file')
    with open(jpath, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert j.books()["balanced"] and any("unparseable mid-file" in p for p in j.audit())
    other = (torch_journal if mod is jax_journal else jax_journal).RequestJournal(jpath)
    assert other.books() == j.books() and other.audit() == j.audit()


@pytest.mark.parametrize("mod", [jax_journal, torch_journal], ids=["jax", "torch"])
def test_journal_rejects_unknown_kind_and_double_terminal(mod, tmp_path):
    j = mod.RequestJournal(str(tmp_path / "j.jsonl"))
    with pytest.raises(ValueError, match="unknown journal record kind"):
        j.append("vanished", 0)
    j.append("submitted", 0, prompt_len=2, max_new_tokens=1, input_ids=[[1, 2]], rng_seed=1, deadline_s=None)
    j.append("terminal", 0, outcome="ok", tokens_out=1)
    j.append("terminal", 0, outcome="ok", tokens_out=1)
    assert any("2 terminal records" in p for p in j.audit())
    j.append("terminal", 9, outcome="error")
    assert any("terminal without a submitted record" in p for p in j.audit())
    assert mod.JOURNAL_KINDS == jax_journal.JOURNAL_KINDS


@pytest.mark.parametrize("front", ["engine", "sequential"])
def test_frontend_journals_submit_shed_and_terminal(models, tmp_path, front):
    """The write-ahead discipline on both front ends: ``submitted`` before
    admission (a shed closes its entry with a terminal record), served
    requests close at their terminal outcome; the journal balances with
    the books."""
    _, _, tm = models
    jpath = str(tmp_path / "fe.jsonl")
    if front == "engine":
        fe = _engine(tm, journal=jpath)
        impossible = RequestSpec(index=99, prompt_len=20, max_new_tokens=16,
                                 input_ids=np.random.default_rng(3).integers(0, VOCAB, size=(1, 20)), rng_seed=7)
        want = {"ok": 3, "shed": 1}
    else:
        fe = serving.RequestFrontEnd(tm, num_latents=NUM_LATENTS, journal=jpath, device="cpu",
                                     config=serving.FrontEndConfig(max_queue=3))
        impossible = dataclasses.replace(_specs(1, seed=9)[0], index=99)
        want = {"ok": 3, "shed": 1}
    fe.run_closed(list(_specs(3)) + [impossible], concurrency=4)
    assert isinstance(fe.journal, serving.RequestJournal)
    j = serving.RequestJournal(jpath)
    jb = j.books()
    assert jb["submitted"] == 4 and jb["balanced"] and jb["outcomes"] == want, jb
    assert j.audit() == []
    kinds = [(r["kind"], r["index"]) for r in j.rows()]
    assert kinds.index(("submitted", 99)) < kinds.index(("terminal", 99))
    assert ("admitted", 99) not in kinds
    if front == "engine":
        shed = [r for r in j.rows() if r["kind"] == "terminal" and r["index"] == 99]
        assert shed[0]["shed_reason"] == "kv_pages_exhausted"
