"""The port's sequential ``RequestFrontEnd`` against the JAX package's, on the
CPU: the same seeded requests, fault plan and ``ManualClock`` go through both
front ends (the port's model holds JAX's weights through
``convert.state_dict_from_jax``), and they must book the same outcomes, shed
reasons, ``tokens_out`` and ``attempts``, the same ``books()``, the same
greedy streams (token by token through the ``on_token`` seam), the same
multiset of event kinds and the same ``request`` rows (outcome, shed reason,
tokens out), exactly. Timing fields are never compared, nor are ``compile``
rows: a JAX call compiles on the CPU, the port's eager step never captures
(a port ``compile`` event means "this step captured", on the card).
``validate_events`` must be clean on every port stream.

Mirrors ``tests/test_serving.py`` minus what needs ``FlightRecorder``,
``ObsServer``, SLO reports, ``run_load`` or the probes' sentinel, which
``tests/test_torch_obs_load.py`` holds. One geometry (prompt 10, 4 new
tokens), as there."""

import collections
import sys
import threading
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

CONFIG = dict(vocab_size=50, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
SIDES = {
    "jax": types.SimpleNamespace(serving=jax_serving, events=jax_events, faults=jax_faults,
                                 generation=jax_generation, loadgen=jax_loadgen),
    "torch": types.SimpleNamespace(serving=torch_serving, events=torch_events, faults=torch_faults,
                                   generation=torch_generation, loadgen=torch_loadgen),
}


def spec_for(ns):
    return ns.loadgen.WorkloadSpec(seed=7, prompt_lens=(10,), max_new_tokens=(4,))


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, 50, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return {"jax": (jm, params), "torch": (tm,)}


def make_frontend(models, side, tmp_path, *, clock=None, injector=None, config=None, label=None):
    """One side's front end on its own event log (``tmp_path/label``), its
    greedy streams recorded at the ``on_token`` seam (token i of the request
    being served, before the seam's own checks)."""
    ns = SIDES[side]
    clock = clock or ns.serving.ManualClock()
    out = str(tmp_path / (label or side))
    events = ns.events.EventLog(out, main_process=True)
    extra = {} if side == "jax" else {"device": "cpu"}
    fe = ns.serving.RequestFrontEnd(*models[side], num_latents=4, config=config, events=events, clock=clock,
                                    sleep=clock.sleep, injector=injector, **extra)
    fe.streams = collections.defaultdict(list)
    seam = fe._on_token

    def on_token(i, token):
        if fe._active is not None:
            fe.streams[fe._active.record.index].append(int(token[0]))
        seam(i, token)

    fe._on_token = on_token
    fe.out = out
    return fe


def outcome_of(fe, side):
    """What both front ends must agree on, exactly."""
    ns = SIDES[side]
    rows = ns.events.merged_events(fe.out)
    return {
        "records": [(r.index, r.outcome, r.shed_reason, r.tokens_out, r.attempts, r.probe, r.error)
                    for r in fe.records],
        "books": fe.books(),
        "streams": dict(fe.streams),
        "kinds": sorted(collections.Counter(e["event"] for e in rows if e["event"] != "compile").items()),
        "requests": [(e["outcome"], e.get("shed_reason"), e["tokens_out"], e.get("queue_expired"))
                     for e in rows if e["event"] == "request"],
        "retries": [(e["request_index"], e["attempt"]) for e in rows if e["event"] == "serve.retry"],
        "breaker": [(e["prev"], e["state"], e["reason"]) for e in rows if e["event"] == "serve.breaker"],
    }


def both(models, tmp_path, scenario):
    """Run ``scenario(ns, side)`` (which returns its front end) on both
    packages; the port's stream validates; the two agree. Returns the
    port's front end and the agreed outcome."""
    got = {}
    fes = {}
    for side in ("jax", "torch"):
        fes[side] = scenario(SIDES[side], side)
        got[side] = outcome_of(fes[side], side)
    assert torch_events.validate_events(fes["torch"].out, warnings_out=[]) == []
    assert got["torch"] == got["jax"]
    return fes["torch"], got["torch"]


def retry(ns, **kw):
    return ns.faults.RetryPolicy(**kw)


# ----------------------------------------------------- admission / shedding


def test_admission_sheds_are_first_class(models, tmp_path):
    """queue_full / deadline_unmeetable / draining sheds: never served, never
    silent; each books as terminal `shed` with a reasoned request row."""
    def scenario(ns, side):
        fe = make_frontend(models, side, tmp_path,
                           config=ns.serving.FrontEndConfig(max_queue=3, est_service_s=1.0, breaker=None))
        specs = spec_for(ns).draw(8, 50)
        fe.submit(specs[0])
        fe.submit(specs[1])
        late = fe.submit(specs[3], deadline_s=1.5)
        assert late.outcome == "shed" and late.shed_reason == "deadline_unmeetable"
        fe.submit(specs[4], deadline_s=60.0)
        full = fe.submit(specs[2])
        assert full.shed_reason == "queue_full"
        fe.pump()
        fe._draining = True
        assert fe.submit(specs[5]).shed_reason == "draining"
        assert fe.audit() == []
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert [r[1] for r in got["requests"] if r[0] == "shed"] == [
        "deadline_unmeetable", "queue_full", "draining"]
    assert fe.registry.counter("serve_shed_total").value == 3


def test_closed_loop_clean_path_books_and_metrics(models, tmp_path):
    def scenario(ns, side):
        fe = make_frontend(models, side, tmp_path)
        recs = fe.run_closed(spec_for(ns).draw(5, 50), concurrency=2)
        assert [r.outcome for r in recs] == ["ok"] * 5
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert got["books"]["max_queue_depth"] == 2 and all(len(s) == 4 for s in got["streams"].values())
    assert fe.registry.counter("serve_admitted_total").value == 5
    assert fe.registry.gauge("serve_queue_depth").value == 0
    assert fe.registry.histogram("generate_queue_wait_s").n == 5


# ------------------------------------------------- mid-decode cancellation


def test_deadline_mid_decode_times_out_with_partial_stats(models, tmp_path):
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock).stall_at(1, 1, 9.0)
        fe = make_frontend(models, side, tmp_path, clock=clock, injector=inj)
        recs = fe.run_closed(spec_for(ns).draw(3, 50), concurrency=1, deadline_s=2.0)
        assert [r.outcome for r in recs] == ["ok", "timeout", "ok"]
        assert 0 < recs[1].tokens_out < 4 and recs[1].service_s >= 9.0
        return fe

    fe, _ = both(models, tmp_path, scenario)
    row = next(e for e in torch_events.merged_events(fe.out)
               if e["event"] == "request" and e["outcome"] == "timeout")
    assert row["ttft_s"] > 0 and row["tpot_hist"], "partial TTFT/TPOT missing"
    assert row["tokens_out"] == fe.records[1].tokens_out


def test_queue_expired_deadline_times_out_without_serving(models, tmp_path):
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock).stall_at(0, 1, 5.0)
        fe = make_frontend(models, side, tmp_path, clock=clock, injector=inj,
                           config=ns.serving.FrontEndConfig(admission_projection=False, breaker=None))
        recs = fe.run_closed(spec_for(ns).draw(2, 50), concurrency=2, deadline_s=1.0)
        assert recs[1].outcome == "timeout" and recs[1].tokens_out == 0 and recs[1].queue_wait_s >= 5.0
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert fe.registry.counter("serve_queue_expired_total").value == 1
    assert [r for r in got["requests"] if r[3]] == [("timeout", None, 0, True)]


def test_cancel_queued_and_mid_decode(models, tmp_path):
    def scenario(ns, side):
        inj = ns.serving.FaultInjector()
        inj.kill_at(0, 1, exc=lambda: ns.generation.GenerationAborted("client went away"))
        fe = make_frontend(models, side, tmp_path, injector=inj)
        for s in spec_for(ns).draw(3, 50):
            fe.submit(s)
        assert fe.cancel(2) is True and fe.cancel(99) is False
        fe.pump()
        return fe

    _, got = both(models, tmp_path, scenario)
    assert [(r[0], r[1], r[3]) for r in got["records"]] == [(0, "cancelled", 2), (1, "ok", 4), (2, "cancelled", 0)]


# --------------------------------------------------------- pre-decode retry


def test_transient_predecode_failures_retried_with_events(models, tmp_path):
    def scenario(ns, side):
        inj = ns.serving.FaultInjector().fail_prefill(1, times=2)
        fe = make_frontend(models, side, tmp_path, injector=inj,
                           config=ns.serving.FrontEndConfig(retry=retry(ns, max_retries=3, base_delay=0.01)))
        assert [r.outcome for r in fe.run_closed(spec_for(ns).draw(3, 50), concurrency=1)] == ["ok"] * 3
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert got["retries"] == [(1, 0), (1, 1)] and got["records"][1][4] == 3
    assert fe.registry.counter("serve_retries_total").value == 2
    assert len(got["requests"]) == 3  # one terminal row per request, retries or not


def test_predecode_retry_exhaustion_books_original_error(models, tmp_path):
    def scenario(ns, side):
        inj = ns.serving.FaultInjector().fail_prefill(0, times=9)
        fe = make_frontend(models, side, tmp_path, injector=inj,
                           config=ns.serving.FrontEndConfig(retry=retry(ns, max_retries=1, base_delay=0.01)))
        assert [r.outcome for r in fe.run_closed(spec_for(ns).draw(2, 50), concurrency=1)] == ["error", "ok"]
        return fe

    fe, got = both(models, tmp_path, scenario)
    err = got["records"][0][6]
    assert "OSError" in err and "FetchRetriesExhausted" not in err and got["records"][0][4] == 2
    row = next(e for e in torch_events.merged_events(fe.out) if e["event"] == "request")
    assert "OSError" in row["error"] and row.get("span_id")


def test_decode_path_transient_never_retried(models, tmp_path):
    """A transient-typed failure from inside the decode path books one error
    with one attempt: the wrapper already emitted its row, and the streamed
    tokens are gone."""
    def scenario(ns, side):
        inj = ns.serving.FaultInjector().kill_at(0, 2, exc=lambda: OSError("nic died mid-stream"))
        fe = make_frontend(models, side, tmp_path, injector=inj,
                           config=ns.serving.FrontEndConfig(retry=retry(ns, max_retries=3, base_delay=0.01)))
        fe.run_closed(spec_for(ns).draw(2, 50), concurrency=1)
        return fe

    _, got = both(models, tmp_path, scenario)
    assert got["records"][0][1:5] == ("error", None, 3, 1) and "nic died" in got["records"][0][6]
    assert [r[0] for r in got["requests"]] == ["error", "ok"]


def test_prologue_failure_still_gets_its_one_stream_row(models, tmp_path):
    def scenario(ns, side):
        fe = make_frontend(models, side, tmp_path)
        bad = ns.loadgen.RequestSpec(index=0, prompt_len=10, max_new_tokens=4,
                                     input_ids=np.zeros((10,), np.int32), rng_seed=1)  # 1-D!
        fe.submit(bad)
        fe.submit(spec_for(ns).draw(2, 50)[1])
        fe.pump()
        return fe

    _, got = both(models, tmp_path, scenario)
    assert [r[0] for r in got["requests"]] == ["error", "ok"]


# ------------------------------------------------------- breaker, end to end


def test_breaker_trips_sheds_and_recovers_end_to_end(models, tmp_path):
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock)
        for i in (1, 2, 3):
            inj.kill_at(i, 1)
        cfg = ns.serving.FrontEndConfig(breaker=ns.serving.BreakerConfig(
            window=4, min_requests=3, error_rate_to_open=0.5,
            probe_backoff=retry(ns, base_delay=2.0, max_delay=10.0, jitter=0.0)))
        fe = make_frontend(models, side, tmp_path, clock=clock, injector=inj, config=cfg)
        specs = spec_for(ns).draw(10, 50)
        recs = fe.run_closed(specs[:8], concurrency=1)
        assert fe.breaker.state == "open" and any(r.shed_reason == "breaker_open" for r in recs)
        assert fe.registry.gauge("serve_breaker_state").value == 2
        clock.advance(2.0)
        probe = fe.submit(specs[8])
        fe.pump()
        assert probe.probe and probe.outcome == "ok" and fe.breaker.state == "closed"
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert [t[1] for t in got["breaker"]] == ["open", "half_open", "closed"]
    assert fe.registry.gauge("serve_breaker_state").value == 0


def test_timed_out_probe_does_not_close_breaker(models, tmp_path):
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock)
        for i in (0, 1):
            inj.kill_at(i, 1)
        cfg = ns.serving.FrontEndConfig(admission_projection=False, breaker=ns.serving.BreakerConfig(
            window=4, min_requests=2, error_rate_to_open=0.5, probe_backoff=retry(ns, base_delay=1.0, jitter=0.0)))
        fe = make_frontend(models, side, tmp_path, clock=clock, injector=inj, config=cfg)
        specs = spec_for(ns).draw(5, 50)
        fe.run_closed(specs[:2], concurrency=1)
        clock.advance(1.1)
        probe = fe.submit(specs[2], deadline_s=0.5)
        clock.advance(2.0)
        fe.pump()
        assert probe.probe and probe.outcome == "timeout" and fe.breaker.state == "half_open"
        nxt = fe.submit(specs[3])
        fe.pump()
        assert nxt.probe and nxt.outcome == "ok" and fe.breaker.state == "closed"
        return fe

    both(models, tmp_path, scenario)


def test_poisoned_request_restores_the_weights(models, tmp_path):
    """A poisoned request is served NaN weights for its whole decode (JAX's
    serve_params), written into the port's parameters in place; afterwards
    every parameter is bit for bit what it was, and the next stream equals
    the unpoisoned one."""
    tm = models["torch"][0]
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    def scenario(side, poison=(1,), label=None):
        ns = SIDES[side]
        injector = ns.serving.FaultInjector()
        for i in poison:
            injector.poison_at(i)
        fe = make_frontend(models, side, tmp_path, injector=injector, label=label)
        fe.run_closed(spec_for(ns).draw(3, 50), concurrency=1)
        return fe

    fe = scenario("torch")
    assert [r.outcome for r in fe.records] == ["ok"] * 3
    assert [i["kind"] for i in fe._injector.injected] == ["poison"]
    assert fe.streams[1] != scenario("torch", (), "clean").streams[1], "the NaN never reached the logits"
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    clean = scenario("torch", (), "clean2")
    assert fe.streams[0] == clean.streams[0] and fe.streams[2] == clean.streams[2]
    jfe = scenario("jax")
    assert outcome_of(jfe, "jax")["records"] == outcome_of(fe, "torch")["records"]
    assert torch_events.validate_events(fe.out, warnings_out=[]) == []


# ------------------------------------------------------------------- drain


def test_guard_trip_drains_and_books_balance(models, tmp_path):
    def scenario(ns, side):
        fe = make_frontend(models, side, tmp_path)
        guard = ns.faults.PreemptionGuard()
        fe._guard = guard  # tripped programmatically (no real signal in a test worker)
        specs = spec_for(ns).draw(6, 50)
        for s in specs[:4]:
            fe.submit(s)
        fe.pump(max_requests=1)
        guard.trip()
        fe.pump()
        late = [fe.submit(s) for s in specs[4:]]
        books = fe.drain()
        assert all(r.shed_reason == "draining" for r in late) and books["balanced"]
        assert fe.health()["status"] == "draining"
        return fe

    fe, got = both(models, tmp_path, scenario)
    assert got["books"]["ok"] == 4 and got["books"]["shed"] == 2
    kinds = dict(got["kinds"])
    assert kinds["serve.preempt"] == 1 and kinds["serve.drain"] == 1


def test_open_loop_overload_sheds_identically(models, tmp_path):
    """An open-loop overload under a ManualClock (a uniform stall a token,
    deadlines, the EWMA service estimate) books the same sheds and timeouts
    in both packages: every admission decision reads the injected clock."""
    def scenario(ns, side):
        clock = ns.serving.ManualClock()
        inj = ns.serving.FaultInjector(clock=clock).stall_at(None, 1, 0.1)
        fe = make_frontend(models, side, tmp_path, clock=clock, injector=inj,
                           config=ns.serving.FrontEndConfig(max_queue=32, est_service_s=0.1))
        fe.run_open(spec_for(ns).draw(20, 50), rate_rps=50.0, deadline_s=0.5, seed=11)
        assert fe.audit() == []
        return fe

    _, got = both(models, tmp_path, scenario)
    assert got["books"]["shed"] > 0 and got["books"]["ok"] > 0


# ------------------------------------------------------- the port's own pins


def test_books_snapshot_is_consistent_under_scrape_hammer(models, tmp_path):
    """A scrape thread hammering books() while the serving thread books
    outcomes always sees a consistent terminal decomposition (one
    _books_lock'd snapshot)."""
    fe = make_frontend(models, "torch", tmp_path)
    stop = threading.Event()
    torn = []

    def scrape():
        while not stop.is_set():
            b = fe.books()
            if b["terminal"] != sum(b[o] for o in torch_serving.TERMINAL_OUTCOMES):
                torn.append(b)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    t = threading.Thread(target=scrape)
    t.start()
    try:
        fe.run_closed(spec_for(SIDES["torch"]).draw(6, 50), concurrency=2)
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert torn == [], f"torn books snapshot(s): {torn[:3]}"
    assert fe.books()["balanced"] and fe.audit() == []


def test_default_registry_shares_the_injected_clock(models, tmp_path):
    fe = make_frontend(models, "torch", tmp_path)
    assert fe.registry._clock is fe._clock


def test_unported_options_raise(models, tmp_path):
    """int8 weights (A10) serve: a front end with ``weight_dtype=torch.int8``
    books the same outcomes and token counts as JAX's with ``jnp.int8`` (the
    streams' equality is ``tests/test_torch_int8.py``'s)."""
    fes = {}
    for side, dtype in (("torch", torch.int8), ("jax", jnp.int8)):
        ns = SIDES[side]
        clock = ns.serving.ManualClock()
        extra = {} if side == "jax" else {"device": "cpu"}
        fe = ns.serving.RequestFrontEnd(*models[side], num_latents=4, weight_dtype=dtype, clock=clock,
                                        sleep=clock.sleep, **extra)
        fe.run_closed(spec_for(ns).draw(3, 50), concurrency=1)
        fes[side] = fe
    assert fes["torch"].books()["ok"] == 3 and fes["torch"].books() == fes["jax"].books()
    assert [(r.outcome, r.tokens_out) for r in fes["torch"].records] == \
        [(r.outcome, r.tokens_out) for r in fes["jax"].records]
