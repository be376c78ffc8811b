"""The admission tier's host-side pieces of the port against the JAX
package's: the circuit breaker (the scripts of ``tests/test_serving.py``, run
against both ``CircuitBreaker``s, which must make the same transitions in the
same order), the ``FaultInjector`` plan and its audit, ``ManualClock``,
``poison_params`` on a ``state_dict``, the outcome vocabulary, the seeded
request mix and Poisson schedule (``obs.loadgen``), the metrics registry and
``validate_events``."""

import numpy as np
import pytest
import torch

from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.obs import loadgen as jax_loadgen
from perceiver_io_tpu.training.faults import RetryPolicy as JaxRetryPolicy
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.generation import GenerationAborted, GenerationDeadlineExceeded
from perceiver_io_tpu_torch.obs import loadgen
from perceiver_io_tpu_torch.obs.events import REQUEST_OUTCOMES, EventLog, validate_events
from perceiver_io_tpu_torch.obs.metrics import MetricsRegistry
from perceiver_io_tpu_torch.training.faults import RetryPolicy

SIDES = {"jax": (jax_serving, JaxRetryPolicy), "torch": (serving, RetryPolicy)}


def _breaker(side, transitions, **config):
    sv, policy = SIDES[side]
    backoff = config.pop("probe_backoff", {})
    clock = sv.ManualClock()
    cfg = sv.BreakerConfig(probe_backoff=policy(**backoff), **config) if backoff else sv.BreakerConfig(**config)
    br = sv.CircuitBreaker(cfg, clock=clock, on_transition=lambda p, n, r, d: transitions.append((p, n, r, d)))
    return br, clock


def _script_error_rate_and_probe_cycle(side):
    transitions = []
    br, clock = _breaker(side, transitions, window=4, min_requests=3, error_rate_to_open=0.5,
                         probe_backoff=dict(base_delay=1.0, max_delay=8.0, jitter=0.0))
    verdicts = [br.allow()]
    br.record(True)
    br.record(False)
    assert br.state == "closed"  # min_requests guards the tiny sample
    br.record(False)
    assert br.state == "open" and br.error_rate() == pytest.approx(2 / 3)
    verdicts.append(br.allow())
    clock.advance(0.99)
    verdicts.append(br.allow())
    clock.advance(0.02)
    verdicts += [br.allow(), br.allow()]  # the probe, then a shed: one probe in flight
    br.record(False, probe=True)  # reopen at the next rung (2.0 s)
    clock.advance(1.5)
    verdicts.append(br.allow())
    clock.advance(0.6)
    verdicts.append(br.allow())
    br.record(True, probe=True)
    br.record(False)  # the failure window was reset: one old error cannot re-trip
    assert br.state == "closed" and br.n_opens == 0
    return transitions, verdicts, br.health()


def _script_unjudged_probe(side):
    transitions = []
    br, clock = _breaker(side, transitions, window=4, min_requests=2, error_rate_to_open=0.5,
                         probe_backoff=dict(base_delay=1.0, jitter=0.0))
    br.record(False)
    br.record(False)
    clock.advance(1.1)
    verdicts = [br.allow()]
    br.release_probe()  # timed out or cancelled: unjudged, not closed
    assert br.state == "half_open"
    verdicts.append(br.allow())
    br.record(True, probe=True)
    assert br.state == "closed"
    return transitions, verdicts, br.health()


def _script_stale_probe(side):
    transitions = []
    br, clock = _breaker(side, transitions, window=4, min_requests=2, error_rate_to_open=0.5,
                         probe_backoff=dict(base_delay=1.0, jitter=0.0))
    br.record(False)
    br.record(False)
    clock.advance(1.1)
    verdicts = [br.allow()]
    stale = br.cycle
    br.record_sentinel("nonfinite-logits")
    br.record(True, probe=True, cycle=stale)  # a stale probe cannot close the new cycle
    assert br.state == "open"
    clock.advance(2.1)
    verdicts.append(br.allow())
    br.release_probe(cycle=stale)  # nor free its probe slot
    verdicts.append(br.allow())
    br.record(True, probe=True, cycle=br.cycle)
    assert br.state == "closed"
    return transitions, verdicts, br.health()


def _script_sentinel_and_health(side):
    transitions = []
    br, clock = _breaker(side, transitions)
    br.record_sentinel("nonfinite-logits")
    health = br.health()
    br.record_sentinel()  # already open: no double count
    assert br.opens_total == 1 and health["probe_in_s"] > 0
    return transitions, [], health


@pytest.mark.parametrize("script", [_script_error_rate_and_probe_cycle, _script_unjudged_probe,
                                    _script_stale_probe, _script_sentinel_and_health],
                         ids=["error_rate_probe_cycle", "unjudged_probe", "stale_probe", "sentinel_health"])
def test_breaker_scripts_transition_as_jax(script):
    """Each script drives both breakers through the same calls on their own
    ManualClock: the same transitions (state, reason, details: the jittered
    probe delays included), verdicts and health, in the same order."""
    assert script("torch") == script("jax")


def test_manual_clock_semantics():
    c = serving.ManualClock(1.0)
    c.advance(0.5)
    c.advance_to(1.2)  # never backwards
    assert c() == 1.5
    c.sleep(0.5)
    assert c() == 2.0
    with pytest.raises(ValueError):
        c.advance(-1.0)


def _injector_plan(side):
    sv = SIDES[side][0]
    clock = sv.ManualClock()
    inj = sv.FaultInjector(clock=clock)
    inj.stall_at(None, 1, 0.2).stall_at(3, 2, 1.0).kill_at(3, 3)
    inj.on_token(0, 0)
    inj.on_token(0, 1)
    times = [clock()]
    inj.on_token(3, 2)
    times.append(clock())
    with pytest.raises(sv.InjectedFault, match="request 3 token 3"):
        inj.on_token(3, 3)
    inj.on_token(3, 3)  # kills fire once
    inj2 = sv.FaultInjector().fail_prefill(1, times=2, exc_type=TimeoutError)
    for _ in range(2):
        with pytest.raises(TimeoutError):
            inj2.before_attempt(1)
    inj2.before_attempt(1)
    inj2.before_attempt(0)
    seeded = sorted(sv.FaultInjector().seeded_kills(50, 0.2, seed=3)._kills)
    return times, inj.injected, [{k: v for k, v in i.items() if k != "error"} for i in inj2.injected], seeded


def test_fault_injector_plan_and_audit_match_jax():
    times, injected, prefill, seeded = _injector_plan("torch")
    assert times == pytest.approx([0.2, 1.2])
    assert [i["kind"] for i in injected] == ["stall", "stall", "kill"]
    assert (times, injected, prefill, seeded) == _injector_plan("jax")
    assert seeded and seeded != sorted(serving.FaultInjector().seeded_kills(50, 0.2, seed=4)._kills)


def test_fault_injector_replica_levers():
    inj = serving.FaultInjector().kill_replica_at("r0", 2).brownout_replica("r1", 3.0)
    inj.on_replica_step("r0", 1)
    with pytest.raises(serving.EngineCrash):
        inj.on_replica_step("r0", 2)
    inj.on_replica_step("r0", 3)  # one-shot
    assert inj.latency_factor("r1") == 3.0 and inj.latency_factor(None) == 1.0
    inj.clear_brownout("r1")
    assert inj.latency_factor("r1") == 1.0
    assert not issubclass(serving.EngineCrash, Exception)
    with pytest.raises(ValueError):
        inj.brownout_replica("r2", 0.0)


def test_poison_params_plants_one_nan_in_a_state_dict():
    model = torch.nn.Sequential(torch.nn.Embedding(5, 3), torch.nn.Linear(3, 2))
    model.register_buffer("ids", torch.arange(3))
    sd = model.state_dict()
    poisoned = serving.poison_params(sd)
    assert torch.isnan(poisoned["0.weight"]).sum() == 1 and torch.isnan(poisoned["0.weight"].view(-1)[0])
    assert not any(torch.isnan(t.float()).any() for t in sd.values())  # the originals untouched
    assert all(poisoned[k] is sd[k] for k in sd if k != "0.weight")
    by_filter = serving.poison_params(sd, path_filter="1.bias")
    assert torch.isnan(by_filter["1.bias"]).sum() == 1 and by_filter["0.weight"] is sd["0.weight"]
    with pytest.raises(ValueError, match="no float leaf to poison"):
        serving.poison_params({"ids": torch.arange(3)})
    with pytest.raises(ValueError, match="path_filter='missing'"):
        serving.poison_params(sd, path_filter="missing")
    inj = serving.FaultInjector().poison_at(1)
    assert inj.params_for(0, sd) is sd
    assert torch.isnan(inj.params_for(1, sd)["0.weight"]).any() and inj.injected == [{"kind": "poison", "request": 1}]


def test_outcome_vocabulary_and_abort_outcomes():
    assert frozenset(serving.TERMINAL_OUTCOMES) == REQUEST_OUTCOMES
    assert serving.TERMINAL_OUTCOMES == jax_serving.TERMINAL_OUTCOMES
    assert serving.SHED_REASONS == jax_serving.SHED_REASONS
    assert GenerationAborted.outcome == "cancelled" and GenerationDeadlineExceeded.outcome == "timeout"
    assert issubclass(GenerationDeadlineExceeded, GenerationAborted)


def test_workload_draws_and_schedule_equal_jax():
    for kw in (dict(seed=7), dict(seed=3, prompt_lens=(8, 12), max_new_tokens=(4, 9), shared_prefix_len=5)):
        ours, theirs = loadgen.WorkloadSpec(**kw).draw(6, 50), jax_loadgen.WorkloadSpec(**kw).draw(6, 50)
        for a, b in zip(ours, theirs):
            assert (a.index, a.prompt_len, a.max_new_tokens, a.rng_seed) == (
                b.index, b.prompt_len, b.max_new_tokens, b.rng_seed)
            np.testing.assert_array_equal(a.input_ids, b.input_ids)
        assert loadgen.WorkloadSpec(**kw).to_dict() == jax_loadgen.WorkloadSpec(**kw).to_dict()
    assert loadgen.arrival_schedule(5, 20.0, seed=2) == jax_loadgen.arrival_schedule(5, 20.0, seed=2)
    with pytest.raises(ValueError):
        loadgen.WorkloadSpec(prompt_lens=(4,), shared_prefix_len=4)
    assert serving.RequestSpec is loadgen.RequestSpec


def test_registry_rate_limits_on_the_injected_clock(tmp_path):
    clock = serving.ManualClock()
    reg = MetricsRegistry(clock=clock)
    events = EventLog(str(tmp_path), main_process=True)
    assert reg.maybe_emit(events, min_interval_s=30.0) is False  # empty registry
    reg.counter("serve_submitted_total").inc()
    reg.counter("serve_submitted_total").labels(tenant="a").inc()
    reg.gauge("serve_queue_depth").set(3)
    reg.gauge("serve_queue_depth").set(1)
    reg.histogram("generate_ttft_s").record(0.25)
    assert reg.maybe_emit(events, min_interval_s=30.0) is False  # 0 s on the clock
    clock.advance(30.0)
    assert reg.maybe_emit(events, min_interval_s=30.0) is True
    assert reg.gauge("serve_queue_depth").peak == 3
    text = reg.to_prometheus()
    assert 'serve_submitted_total{tenant="a"} 1' in text and 'generate_ttft_s_bucket{le="+Inf"} 1' in text
    assert validate_events(str(tmp_path), warnings_out=[]) == []


def test_validate_events_flags_what_jax_flags(tmp_path):
    events = EventLog(str(tmp_path), main_process=True)
    events.emit("request", request_id="r", batch=1, prompt_len=4, ttft_s=0.0, tokens_out=0, outcome="ok",
                batch_size_at_decode=True, span_id="0123456789abcdef")
    events.emit("serve.breaker", state="open", prev="closed")
    events.emit("serve.brand_new", x=1)
    warnings = []
    problems = validate_events(str(tmp_path), warnings_out=warnings)
    assert any("batch_size_at_decode" in p for p in problems)
    assert any("missing field 'reason'" in p for p in problems)
    assert any("has no span row" in p for p in problems)
    assert len(warnings) == 1 and "serve.brand_new" in warnings[0]


def test_recompile_tracker_books_a_decode_steps_capture(tmp_path):
    """A ``compile`` event of the serving path means "this step captured":
    the tracker reads the ``captures`` count of a step that carries one
    itself (the engine's ``_GraphedStep``) or through ``captured`` (the
    decode pair's step), and books nothing for a step that never captures
    (the eager step on the CPU)."""
    from perceiver_io_tpu_torch.obs.events import merged_events
    from perceiver_io_tpu_torch.obs.recompile import RecompileTracker

    class Step:  # the part of generation._GraphedStep the tracker reads
        def __init__(self):
            self.captures, self.capture_s = 0, []

        def __call__(self, state):
            if not self.captures:
                self.captures, self.capture_s = 1, [0.25]
            return state

    events = EventLog(str(tmp_path), main_process=True)
    tracker = RecompileTracker(events=events)
    graphed, pair = Step(), Step()

    def pair_step(state):
        return pair(state)

    pair_step.captured = pair
    steps = [tracker.wrap(graphed, "engine_decode_step"), tracker.wrap(pair_step, "generate_decode_step"),
             tracker.wrap(lambda state: state, "eager")]
    for _ in range(3):
        for step in steps:
            step({})
    assert tracker.counts() == {"engine_decode_step": 1, "generate_decode_step": 1, "eager": 0}
    assert tracker.total_compile_s == 0.5
    assert [(e["fn"], e["captures"]) for e in merged_events(str(tmp_path))] == [
        ("engine_decode_step", 1), ("generate_decode_step", 1)]
