"""The port's ``EngineFrontEnd`` (a ``RequestFrontEnd``) against the JAX
package's engine, on the CPU: the same seeded specs, fault plan and
``ManualClock`` must book the same outcomes, shed reasons, ``tokens_out``,
``attempts`` and ``books()``, serve the same greedy streams token for token,
and write the same multiset of event kinds and the same ``request`` rows
(outcome, shed reason, tokens out), exactly. Timing fields are never
compared, nor are ``compile`` rows (JAX compiles its join, retire and step
programs on the CPU; the port's eager step never captures). Both engines run
at their default ``prefix_sharing`` (on). Pages of 4 rows keep the JAX
engine on its gather route, as in ``tests/test_torch_graph_paged.py``.

Covers the ``kv_pages_exhausted`` shed (CA and SA), a kill at token 0, a
cancel mid-batch, the events' ``batch_size_at_decode`` and the gauges, queue
expiry, ``run_open`` with explicit offsets, a poisoned prefill (the port's
parameters bit for bit unchanged after it), the drain, and
``chip_smoke.py``'s ``serve_admission_bf16`` fault plan at micro size with
its expected books."""

import collections
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jax_generation
from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs import events as jax_events
from perceiver_io_tpu.obs import loadgen as jax_loadgen
from perceiver_io_tpu.training import faults as jax_faults
from perceiver_io_tpu_torch import generation as torch_generation
from perceiver_io_tpu_torch import serving as torch_serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import events as torch_events
from perceiver_io_tpu_torch.obs import loadgen as torch_loadgen
from perceiver_io_tpu_torch.training import faults as torch_faults

VOCAB, NUM_LATENTS = 64, 4
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2)
ENGINE = dict(slots=4, page_size=4, max_ca_tokens=24, max_sa_tokens=16)
SIDES = {
    "jax": types.SimpleNamespace(serving=jax_serving, events=jax_events, faults=jax_faults,
                                 generation=jax_generation, loadgen=jax_loadgen),
    "torch": types.SimpleNamespace(serving=torch_serving, events=torch_events, faults=torch_faults,
                                   generation=torch_generation, loadgen=torch_loadgen),
}


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return {"jax": (jm, params), "torch": (tm,)}


def make_engine(models, side, tmp_path, *, label=None, clock=None, injector=None, config=None, **engine):
    ns = SIDES[side]
    clock = clock or ns.serving.ManualClock()
    out = str(tmp_path / (label or side))
    extra = {} if side == "jax" else {"device": "cpu"}
    fe = ns.serving.EngineFrontEnd(
        *models[side], num_latents=NUM_LATENTS, engine_config=ns.serving.EngineConfig(**{**ENGINE, **engine}),
        events=ns.events.EventLog(out, main_process=True), clock=clock, sleep=clock.sleep, injector=injector,
        config=config, **extra)
    fe.out = out
    return fe


def outcome_of(fe, side, skip_streams=()):
    rows = SIDES[side].events.merged_events(fe.out)
    return {
        "records": [(r.index, r.outcome, r.shed_reason, r.tokens_out, r.attempts, r.probe) for r in fe.records],
        "books": fe.books(),
        "streams": {i: [int(t) for t in s] for i, s in fe.served_tokens.items() if i not in skip_streams},
        "kinds": sorted(collections.Counter(e["event"] for e in rows if e["event"] != "compile").items()),
        "requests": [(e["outcome"], e.get("shed_reason"), e["tokens_out"], e.get("queue_expired"))
                     for e in rows if e["event"] == "request"],
        "pages": (fe.ca_alloc.pages_used, fe.sa_alloc.pages_used, fe.ca_alloc.audit(), fe.sa_alloc.audit()),
    }


def both(models, tmp_path, scenario, skip_streams=()):
    """``scenario(ns, side)`` on both engines: the port's stream validates,
    the two agree. Returns the port's engine and the agreed outcome."""
    fes = {side: scenario(SIDES[side], side) for side in ("jax", "torch")}
    got = {side: outcome_of(fe, side, skip_streams) for side, fe in fes.items()}
    assert torch_events.validate_events(fes["torch"].out, warnings_out=[]) == []
    assert got["torch"] == got["jax"]
    assert fes["torch"].audit() == []
    return fes["torch"], got["torch"]


def draw(ns, n, seed, prompt_lens=(10,), max_new_tokens=(6,)):
    return ns.loadgen.WorkloadSpec(seed=seed, prompt_lens=prompt_lens, max_new_tokens=max_new_tokens).draw(n, VOCAB)


def test_kv_pages_exhausted_sheds_ca_and_sa(models, tmp_path):
    """A request whose CA window or SA latent stream can never fit sheds
    ``kv_pages_exhausted`` at admission, with its own request row and JAX's
    detail fields; the rest is served; books and page books balance."""
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path)
        rng = np.random.default_rng(9)
        specs = list(draw(ns, 3, 2, max_new_tokens=(4,)))
        specs.append(ns.loadgen.RequestSpec(index=3, prompt_len=20, max_new_tokens=16,
                                            input_ids=rng.integers(0, VOCAB, size=(1, 20)), rng_seed=1))
        specs.append(ns.loadgen.RequestSpec(index=4, prompt_len=6, max_new_tokens=16,  # 4 + 16 > 16 SA tokens
                                            input_ids=rng.integers(0, VOCAB, size=(1, 6)), rng_seed=1))
        fe.run_closed(specs, concurrency=5)
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert [r[1:3] for r in got["records"][3:]] == [("shed", "kv_pages_exhausted")] * 2
    assert got["books"]["ok"] == 3 and got["books"]["shed"] == 2 and got["books"]["balanced"]
    rows = [e for e in torch_events.merged_events(fe.out) if e.get("shed_reason") == "kv_pages_exhausted"]
    assert [(e["ca_tokens"], e["sa_tokens"], e["max_ca_tokens"], e["max_sa_tokens"]) for e in rows] == [
        (36, 20, 24, 16), (22, 20, 24, 16)]


def test_kill_at_token_0_books_one_token(models, tmp_path):
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path, injector=ns.serving.FaultInjector().kill_at(1, 0))
        fe.run_closed(draw(ns, 3, 6), concurrency=3)
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert got["records"][1][1:4] == ("error", None, 1) and len(got["streams"][1]) == 1
    assert got["pages"] == (0, 0, [], [])


def test_cancel_mid_batch_frees_pages(models, tmp_path):
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path)
        for s in draw(ns, 4, 3, max_new_tokens=(8,)):
            fe.submit(s)
        fe._fill_slots()
        assert len(fe._active_ids()) == 4 and fe.ca_alloc.pages_used > 0
        fe._engine_step()
        assert fe.cancel(2)
        fe.pump()
        return fe

    _, got = both(models, tmp_path, scenario)
    assert got["records"][2][1] == "cancelled" and 0 < got["records"][2][3] < 8
    assert got["books"]["ok"] == 3 and got["pages"] == (0, 0, [], [])


def test_events_carry_batch_size_and_gauges(models, tmp_path):
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path)
        fe.run_closed(draw(ns, 6, 4), concurrency=6)
        return fe

    fe, got = both(models, tmp_path, scenario)
    rows = [e for e in torch_events.merged_events(fe.out) if e["event"] == "request"]
    assert len(rows) == 6
    assert all(isinstance(e["batch_size_at_decode"], float) and e["queue_wait_s"] is not None and e["tpot_hist"]
               and e["span_id"] for e in rows)
    snap = fe.registry.snapshot()["gauges"]
    assert "engine_kv_pages_used" in snap and "engine_batch_fill_frac" in snap
    assert 0.0 < fe.mean_batch_fill <= 1.0
    assert fe.registry.histogram("generate_tpot_s").n > 0 and fe.registry.histogram("generate_queue_wait_s").n == 6


def test_queue_expiry(models, tmp_path):
    """Requests whose deadline passes while they wait (a 5 s stall of a
    live slot moves the clock) time out from the queue, unserved, with
    ``queue_expired`` rows."""
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock).stall_at(0, 1, 5.0)
        fe = make_engine(models, side, tmp_path, clock=clock, injector=inj, slots=1,
                         config=ns.serving.FrontEndConfig(admission_projection=False, breaker=None))
        fe.run_closed(draw(ns, 3, 5), concurrency=3, deadline_s=1.0)
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert [r[1] for r in got["records"]] == ["timeout"] * 3
    assert [r for r in got["requests"] if r[3]] == [("timeout", None, 0, True)] * 2
    assert fe.registry.counter("serve_queue_expired_total").value == 2


def test_run_open_with_explicit_offsets(models, tmp_path):
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path, config=ns.serving.FrontEndConfig(max_queue=2))
        specs = draw(ns, 8, 8, prompt_lens=(8, 12), max_new_tokens=(4, 9))
        fe.run_open(specs, offsets=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 3.0])
        with pytest.raises(ValueError, match="non-decreasing"):
            fe.run_open(specs[:2], offsets=[1.0, 0.5])
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert got["books"]["shed"] > 0 and got["books"]["ok"] > 0 and fe._clock() == 3.0


def test_poisoned_prefill_leaves_every_parameter_bit_for_bit(models, tmp_path):
    """The poisoned request's prefill runs on NaN weights written into the
    port's parameters in place; every parameter is bit for bit what it was
    after it, and the other requests' streams equal JAX's (the poisoned
    stream is NaN argmaxes, not compared)."""
    tm = models["torch"][0]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    addresses = {k: v.data_ptr() for k, v in tm.state_dict().items()}

    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path, injector=ns.serving.FaultInjector().poison_at(1))
        fe.run_closed(draw(ns, 4, 12), concurrency=4)
        return fe

    fe, got = both(models, tmp_path, scenario, skip_streams=(1,))
    assert [r[1] for r in got["records"]] == ["ok"] * 4
    assert {k: v.data_ptr() for k, v in tm.state_dict().items()} == addresses
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    clean = make_engine(models, "torch", tmp_path, label="clean")
    clean.run_closed(draw(SIDES["torch"], 4, 12), concurrency=4)
    assert clean.served_tokens[1] != fe.served_tokens[1], "the NaN never reached the poisoned request"
    assert all(clean.served_tokens[i] == fe.served_tokens[i] for i in (0, 2, 3))


def test_drain_finishes_the_batch_and_sheds_late_arrivals(models, tmp_path):
    def scenario(ns, side):
        fe = make_engine(models, side, tmp_path)
        specs = draw(ns, 6, 10)
        for s in specs[:4]:
            fe.submit(s)
        fe._fill_slots()
        fe._engine_step()
        guard = ns.faults.PreemptionGuard()
        fe._guard = guard
        guard.trip()
        fe.pump()
        late = [fe.submit(s) for s in specs[4:]]
        assert [r.shed_reason for r in late] == ["draining"] * 2
        books = fe.drain()
        assert books["balanced"] and fe.health()["status"] == "draining"
        return fe

    _, got = both(models, tmp_path, scenario)
    assert got["books"]["ok"] == 4 and dict(got["kinds"])["serve.drain"] == 1


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_fault_plan_books_as_planned(models, tmp_path):
    """``chip_smoke.py``'s ``serve_admission_bf16`` plan (its specs drawn at
    micro size) books the planned outcomes and shed reasons on both engines,
    with one open, probe, close cycle of the breaker; the port's and JAX's
    books, streams and rows agree (the poisoned request's stream aside)."""
    cs = _chip_smoke()

    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        fe = make_engine(models, side, tmp_path, clock=clock,
                         injector=cs.admission_faults(ns.serving.FaultInjector(clock=clock)),
                         config=cs.admission_config(ns.serving, ns.faults.RetryPolicy))
        specs = cs.admission_specs(ns.loadgen.RequestSpec, VOCAB, (8, 12), (6, 9), ENGINE["max_ca_tokens"])
        cs.admission_drive(fe, specs, clock, ns.faults.PreemptionGuard())
        cs.check_admission_books(side, fe)
        return fe

    fe, got = both(models, tmp_path, scenario, skip_streams=(cs.ADMISSION_POISONED,))
    rows = torch_events.merged_events(fe.out)
    assert [(e["prev"], e["state"]) for e in rows if e["event"] == "serve.breaker"] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    kinds = dict(got["kinds"])
    assert kinds["request"] == 16 and kinds["serve.drain"] == 1 and kinds["serve.preempt"] == 1
    assert got["pages"] == (0, 0, [], [])
