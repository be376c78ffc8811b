"""The port's fleet router (``serving/router.py``) held to the JAX package's.

Side by side: JAX's router over JAX's simulated replicas and the port's
router over the port's simulated replicas (``serving.sim.SimEngineFrontEnd``:
sampled service times over the engine's own host control plane), on one
``ManualClock`` each with the same specs, seeds and faults: least-outstanding
dispatch with its replica-id tie-break, re-dispatch of admission sheds,
drain with no shed, journal failover on an injected kill and on a stale
heartbeat, brownout degradation and restore. Held exactly: the dispatch
order (``_assigned``), ``books()`` (per-replica books included),
``health()``, ``audit()``, failover re-admissions and the ``serve.replica``
and ``serve.failover`` event rows.

Then one failover over two real port engines on the CPU (the plain kernel
versions, one micro CLM's weights shared by both replicas, each with its
own journal): the replica killed mid-decode hands its journal to the
survivor, and every greedy stream equals the one a single engine serves,
token for token."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs import events as jax_events
from perceiver_io_tpu.obs import loadgen as jax_loadgen
from perceiver_io_tpu.obs import metrics as jax_metrics
from perceiver_io_tpu.serving import sim as jax_sim
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import events, loadgen, metrics
from perceiver_io_tpu_torch.serving import sim

VOCAB = 64
MODEL = dict(prefill_p50_s=0.002, prefill_p99_s=0.004, tpot_p50_s=0.0005, tpot_p99_s=0.001, source="test_synthetic")
PACKAGES = {
    "jax": types.SimpleNamespace(serving=jax_serving, sim=jax_sim, events=jax_events, loadgen=jax_loadgen,
                                 metrics=jax_metrics),
    "port": types.SimpleNamespace(serving=serving, sim=sim, events=events, loadgen=loadgen, metrics=metrics),
}


def _specs(pkg, n, seed=13):
    return pkg.loadgen.WorkloadSpec(seed=seed, prompt_lens=(8, 12), max_new_tokens=(3, 4)).draw(n, VOCAB)


def _fleet(pkg, n=2, *, events=None, registry=None, config=None, injector=None, journal_dir=None, max_queue=64):
    """JAX's test fleet: ``n`` simulated replicas on one shared ManualClock,
    breaker and admission projection off."""
    s = pkg.serving
    clock = s.ManualClock()
    router = s.FleetRouter(clock=clock, events=events, registry=registry, config=config, injector=injector)
    fes = {}
    for i in range(n):
        rid = f"r{i}"
        fe = pkg.sim.SimEngineFrontEnd(
            service_model=pkg.sim.ServiceTimeModel(**MODEL),
            engine_config=s.EngineConfig(slots=4, page_size=8, max_ca_tokens=24, max_sa_tokens=8),
            clock=clock, seed=7 + i, replica_id=rid,
            config=s.FrontEndConfig(max_queue=max_queue, admission_projection=False, breaker=None),
            events=events, registry=registry, injector=injector,
            journal=os.path.join(journal_dir, f"journal-{rid}.jsonl") if journal_dir else None)
        router.add_replica(rid, fe)
        fes[rid] = fe
    return router, fes, clock


def _view(router):
    with router._lock:
        assigned = dict(router._assigned)
        states = {rid: (r.state, r.degraded, r.steps, r.ewma_step_s) for rid, r in router._replicas.items()}
    return {"assigned": assigned, "states": states, "books": router.books(), "health": router.health(),
            "audit": router.audit()}


def _rows(pkg, directory, kinds=("serve.replica", "serve.failover")):
    out = []
    for e in pkg.events.merged_events(str(directory)):
        if e.get("event") in kinds:
            out.append({k: v for k, v in e.items() if k not in ("ts", "span_id", "journal", "seq", "pid", "host")})
    return out


def dispatch(pkg, tmp):
    registry = pkg.metrics.MetricsRegistry()
    router, fes, _ = _fleet(pkg, 3, registry=registry)
    recs = [router.submit(s) for s in _specs(pkg, 6)]
    first = dict(router._assigned)
    done = router.pump()
    disp = registry.counter("router_dispatch_total")
    return {"first": first, "done": done, "outcomes": [r.outcome for r in recs], **_view(router),
            "dispatch": [disp.value] + [disp.labels(replica=r).value for r in fes]}


def redispatch(pkg, tmp):
    router, fes, _ = _fleet(pkg, 2, max_queue=2)
    specs = _specs(pkg, 6)
    for s in specs[:4]:
        router.submit(s)
    rec = router.submit(specs[4])
    before = router.books()
    router.pump()
    return {"shed": rec.outcome, "before": before, **_view(router)}


def drain(pkg, tmp):
    log = pkg.events.EventLog(str(tmp), main_process=True)
    router, fes, _ = _fleet(pkg, 2, events=log)
    specs = _specs(pkg, 6)
    for s in specs[:4]:
        router.submit(s)
    router.step()
    router.drain_replica("r0")
    late = [router.submit(s).outcome for s in specs[4:]]
    router.pump()
    return {"late": late, "rows": _rows(pkg, tmp), **_view(router)}


def failover(pkg, tmp):
    log = pkg.events.EventLog(str(tmp), main_process=True)
    injector = pkg.serving.FaultInjector().kill_replica_at("r0", 2)
    router, fes, _ = _fleet(pkg, 2, events=log, injector=injector, journal_dir=str(tmp))
    recs = router.run_closed(_specs(pkg, 6), concurrency=6)
    dead = pkg.serving.RequestJournal(os.path.join(str(tmp), "journal-r0.jsonl"))
    again = router.failover("r0")
    return {"n": len(recs), "rows": _rows(pkg, tmp), "dead_journal": dead.books(), "pending": dead.pending(),
            "again": again, "served": {rid: dict(fe.served_tokens) for rid, fe in fes.items()}, **_view(router)}


def heartbeat(pkg, tmp):
    log = pkg.events.EventLog(str(tmp), main_process=True)
    router, fes, clock = _fleet(pkg, 2, events=log, journal_dir=str(tmp),
                                config=pkg.serving.FleetConfig(heartbeat_timeout_s=1.0))
    specs = _specs(pkg, 5)
    for s in specs[:4]:
        router.submit(s)
    clock.advance(2.0)
    router.heartbeat("r1")
    rec = router.submit(specs[4])
    died = router.check_replicas()
    mid = router.books()
    router.pump()
    return {"died": died, "mid": mid, "outcome": rec.outcome, "rows": _rows(pkg, tmp), **_view(router)}


def brownout(pkg, tmp):
    log = pkg.events.EventLog(str(tmp), main_process=True)
    injector = pkg.serving.FaultInjector().brownout_replica("r1", 10.0)
    router, fes, _ = _fleet(pkg, 2, events=log, injector=injector,
                            config=pkg.serving.FleetConfig(brownout_factor=3.0))
    pending = list(_specs(pkg, 40, seed=5))
    flips = []

    def top_up():
        for rid, fe in fes.items():
            while pending and router._outstanding(fe) < 2:
                rec = pending.pop(0)
                fe.submit(rec)
                with router._lock:
                    router._dispatched += 1
                    router._assigned[int(rec.index)] = rid

    def run_until(degraded):
        for _ in range(200):
            top_up()
            router.step()
            if router._replicas["r1"].degraded == degraded:
                break
        flips.append((router._replicas["r1"].degraded, router._replicas["r0"].degraded, len(pending)))

    run_until(True)
    pick = router._pick().replica_id
    injector.clear_brownout("r1")
    run_until(False)
    router.pump()
    return {"flips": flips, "pick": pick, "rows": _rows(pkg, tmp), **_view(router)}


def health(pkg, tmp):
    router, fes, _ = _fleet(pkg, 2)
    fresh = router.health()
    for s in _specs(pkg, 2):
        router.submit(s)
    router.drain_replica("r1")
    mid = router.health()
    router.pump()
    return {"fresh": fresh, "mid": mid, **_view(router)}


SCENARIOS = {f.__name__: f for f in (dispatch, redispatch, drain, failover, heartbeat, brownout, health)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_laws_equal_jax(name, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = SCENARIOS[name](PACKAGES["port"], tmp_path / "port")
    want = SCENARIOS[name](PACKAGES["jax"], tmp_path / "jax")
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["books"]["balanced"] and got["audit"] == []
    if name == "failover":
        assert got["books"]["failovers"] == 1 and got["books"]["orphaned"] >= 1 and got["again"] is None
        assert got["books"]["outcomes"]["ok"] == 6 and got["dead_journal"]["handed_off"] >= 1
    if name == "brownout":
        assert got["flips"][0][:2] == (True, False) and got["flips"][1][0] is False and got["pick"] == "r0"
    if name == "drain":
        assert [r["transition"] for r in got["rows"] if r["replica_id"] == "r0"] == ["join", "drain", "drained"]


def test_router_refusals():
    router, fes, _ = _fleet(PACKAGES["port"], 1)
    router.drain_replica("r0")
    with pytest.raises(RuntimeError, match="no dispatchable replica"):
        router.submit(_specs(PACKAGES["port"], 1)[0])
    with pytest.raises(ValueError, match="already in the fleet"):
        router.add_replica("r0", fes["r0"])
    lone, _, _ = _fleet(PACKAGES["port"], 1)
    with pytest.raises(RuntimeError, match="no dispatchable survivor"):
        lone.failover("r0")
    pair, _, _ = _fleet(PACKAGES["port"], 2)
    with pytest.raises(RuntimeError, match="no write-ahead journal"):
        pair.failover("r0")


# ---------------------------------------------------------------------------
# real engines on the CPU
# ---------------------------------------------------------------------------

NUM_LATENTS = 4
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
ENGINE = dict(slots=2, page_size=8, max_ca_tokens=16, max_sa_tokens=8)


@pytest.fixture(scope="module")
def model():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return tm


def _engine(tm, clock, **kw):
    return serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, engine_config=serving.EngineConfig(**ENGINE),
                                  clock=clock, sleep=clock.sleep, device="cpu", **kw)


def test_failover_over_real_engines_serves_one_engines_streams(model, tmp_path):
    specs = loadgen.WorkloadSpec(seed=13, prompt_lens=(8, 12), max_new_tokens=(3, 4)).draw(8, VOCAB)
    single = _engine(model, serving.ManualClock())
    single.run_closed(specs, concurrency=4)
    assert single.books()["ok"] == len(specs)

    clock = serving.ManualClock()
    log = events.EventLog(str(tmp_path), main_process=True)
    injector = serving.FaultInjector().kill_replica_at("r0", 2)
    router = serving.FleetRouter(clock=clock, events=log, injector=injector)
    replicas = {}
    for rid in ("r0", "r1"):
        replicas[rid] = _engine(model, clock, injector=injector, events=log,
                                journal=str(tmp_path / f"journal-{rid}.jsonl"))
        router.add_replica(rid, replicas[rid])
    recs = router.run_closed(specs, concurrency=4)
    assert len(recs) == len(specs)
    books = router.books()
    assert books["balanced"] and books["failovers"] == 1 and books["outcomes"]["ok"] == len(specs), books
    assert books["orphaned"] >= 1 and books["orphaned"] == books["readmitted"] + books["readmit_skipped"]
    assert router.audit() == []
    assert replicas["r1"].sharing_audit() == [] and replicas["r1"].ca_alloc._rc == {}
    # the survivor holds every adopted stream whole; r0's own finished ones stay with it
    served = dict(replicas["r0"].served_tokens)
    served.update(replicas["r1"].served_tokens)
    assert served == single.served_tokens
    dead = serving.RequestJournal(str(tmp_path / "journal-r0.jsonl"))
    assert dead.books()["balanced"] and dead.pending() == [] and dead.audit() == []
    rows = [e for e in events.merged_events(str(tmp_path)) if e.get("event") == "serve.failover"]
    assert len(rows) == 1 and rows[0]["dead_replica"] == "r0" and rows[0]["survivor"] == "r1"
    assert events.validate_events(str(tmp_path), strict_spans=False) == []
