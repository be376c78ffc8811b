"""The port's discrete-event serving simulator (``serving/sim.py``) held to
the JAX package's on the same tenants, service model and seeds.

The simulator replaces only the engine's device programs with sampled
service times; admission, paging, prefix sharing (the port's deferred
inserts), eviction, books, journals and the fleet router run the engine's
own code. Both packages sample with numpy from the same seeds, so a run's
whole summary (books included) and its SIM document metrics are held to
JAX's exactly, for a plain two-tenant run, a prefix-sharing tenant, an
eviction run and fleet runs with and without a replica kill; ``diff_sim``
and ``sim_comparability_problems`` answer as JAX's on the same documents;
``ServiceTimeModel.from_load_doc`` fits JAX's parameters and draws JAX's
samples. No model and no device take part: ``time.sleep`` raising anywhere
in a run is part of the check."""

import copy
import dataclasses
import time

import numpy as np
import pytest

from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.serving import sim as jax_sim
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
from perceiver_io_tpu_torch.obs.metrics import MetricsRegistry
from perceiver_io_tpu_torch.serving import sim

PACKAGES = {"jax": (jax_sim, jax_serving), "port": (sim, serving)}
MODEL = dict(prefill_p50_s=0.002, prefill_p99_s=0.004, tpot_p50_s=0.0005, tpot_p99_s=0.001, source="test_synthetic")
CONFIG = dict(max_queue=64, admission_projection=False)


def _tenants(mod, n=120, share=0):
    """JAX's test tenants; ``share`` gives the first tenant a common
    preamble of that many tokens on longer prompts."""
    prompts = (16, 20) if share else (8, 12)
    return [mod.TenantSpec("acme", rate_rps=300.0, n_requests=n, prompt_lens=prompts, max_new_tokens=(4, 6), seed=11,
                           shared_prefix_len=share),
            mod.TenantSpec("bcorp", rate_rps=200.0, n_requests=(2 * n) // 3, prompt_lens=(12,), max_new_tokens=(6,),
                           seed=22)]


RUNS = {
    "plain": (dict(slots=8, page_size=8, max_ca_tokens=24, max_sa_tokens=8), 0, None),
    "sharing": (dict(slots=8, page_size=4, max_ca_tokens=32, max_sa_tokens=8), 12, None),
    "eviction": (dict(slots=4, page_size=8, max_ca_tokens=32, max_sa_tokens=24, pool_headroom=0.5, eviction=True), 0,
                 dict(prefill_p50_s=0.005, prefill_p99_s=0.010, tpot_p50_s=0.004, tpot_p99_s=0.008,
                      source="test_slow")),
}


def _run(name, package, tmp_path=None, seed=3):
    mod, srv = PACKAGES[package]
    engine, share, model = RUNS[name]
    service = mod.ServiceTimeModel(**(model or MODEL))
    events = None if tmp_path is None else EventLog(str(tmp_path), main_process=True)
    report = mod.run_sim(_tenants(mod, share=share), service_model=service, engine_config=srv.EngineConfig(**engine),
                         config=srv.FrontEndConfig(**CONFIG), events=events, registry=None, seed=seed)
    doc = mod.build_sim_doc(1, report.summary, _tenants(mod, share=share), service, srv.EngineConfig(**engine))
    return report, doc


@pytest.fixture
def no_sleep(monkeypatch):
    def _no_sleep(_):
        raise AssertionError("the simulation must never sleep")

    monkeypatch.setattr(time, "sleep", _no_sleep)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_sim_equals_jax(name, tmp_path, no_sleep):
    report, doc = _run(name, "port", tmp_path)
    jreport, jdoc = _run(name, "jax")
    assert report.summary == jreport.summary
    assert sim.sim_doc_metrics(doc) == jax_sim.sim_doc_metrics(jdoc)
    assert doc == jdoc
    fe, s = report.frontend, report.summary
    assert s["books_balanced"] and fe.audit() == [] and fe.sharing_audit() == []
    assert fe.ca_alloc.pages_used == 0 and fe.sa_alloc.pages_used == 0
    assert fe.prefix_index.pages() == () and fe.ca_alloc._rc == {}
    assert report.duration_s > 0.0
    if name == "sharing":
        assert s["prefix_hits"] > 0 and s["prefix_pages_shared"] >= s["prefix_hits"]
    if name == "eviction":
        assert s["evictions"] >= 1 and s["evictions"] == s["resumes"] and s["books"]["parked"] == 0
    stream = merged_events(str(tmp_path))
    reqs = [e for e in stream if e.get("event") == "request"]
    assert len(reqs) == s["n_requests"] and all(e.get("tenant") in ("acme", "bcorp") for e in reqs)
    assert [e for e in stream if e.get("event") == "sim.summary"][0]["n_tenants"] == 2
    warnings = []
    assert validate_events(str(tmp_path), warnings_out=warnings) == [] and warnings == []


FLEETS = {
    "two_replicas": dict(n_replicas=2),
    "kill_r0": dict(n_replicas=2, kill=("r0", 5)),
    "brownout_r1": dict(n_replicas=3, brownout=("r1", 8.0)),
}


def _fleet_run(name, package, tmp_path):
    mod, srv = PACKAGES[package]
    spec = dict(FLEETS[name])
    injector = srv.FaultInjector()
    if "kill" in spec:
        injector.kill_replica_at(*spec.pop("kill"))
    if "brownout" in spec:
        injector.brownout_replica(*spec.pop("brownout"))
    directory = tmp_path / package
    directory.mkdir()
    report = mod.run_fleet_sim(
        _tenants(mod, 60), service_model=mod.ServiceTimeModel(**MODEL),
        engine_config=srv.EngineConfig(slots=4, page_size=8, max_ca_tokens=24, max_sa_tokens=8),
        config=srv.FrontEndConfig(**CONFIG, breaker=None), seed=5, injector=injector,
        journal_dir=str(directory), **spec)
    return report


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_run_fleet_sim_equals_jax(name, tmp_path, no_sleep):
    report, jreport = _fleet_run(name, "port", tmp_path), _fleet_run(name, "jax", tmp_path)
    assert report.summary == jreport.summary
    assert report.duration_s == jreport.duration_s
    s = report.summary
    assert s["books_balanced"] and report.router.audit() == []
    if name == "kill_r0":
        assert s["failovers"] == 1 and s["replicas"]["r0"]["state"] == "dead"
    for fe in report.frontends:
        assert fe.ca_alloc.audit() == [] and fe.sa_alloc.audit() == []


def test_diff_sim_and_comparability_answer_as_jax():
    (_, doc), (_, again) = _run("plain", "port"), _run("plain", "port")
    _, jdoc = _run("plain", "jax")
    assert sim.sim_doc_metrics(doc) == sim.sim_doc_metrics(again)
    assert set(sim.sim_doc_metrics(doc)) <= set(sim.SIM_METRICS) and sim.SIM_METRICS == jax_sim.SIM_METRICS
    worse = copy.deepcopy(again)
    worse["summary"]["fairness_jain"] -= 0.2
    worse["summary"]["ttft_s"]["p99"] *= 1.5
    refit = copy.deepcopy(again)
    refit["service_model"]["source"] = "LOAD_r99"
    other = sim.build_sim_doc(3, doc["summary"], [sim.TenantSpec("acme", rate_rps=999.0, n_requests=5)],
                              sim.ServiceTimeModel(**MODEL), serving.EngineConfig())

    def fields(problems):  # the port's EngineConfig lists its fields in another order: the reprs differ
        return [p.split(":")[0] for p in problems]

    for new in (again, worse, refit, other):
        got, want = sim.diff_sim(doc, new), jax_sim.diff_sim(jdoc, new)
        assert {k: v for k, v in got.items() if k != "reason"} == {k: v for k, v in want.items() if k != "reason"}
        assert fields(got["reason"].split("; ")) == fields(want["reason"].split("; "))
        if got["comparable"]:
            assert sim.format_sim_diff(got) == jax_sim.format_sim_diff(want)
        assert fields(sim.sim_comparability_problems(doc, new)) == fields(
            jax_sim.sim_comparability_problems(jdoc, new))
    assert sim.diff_sim(doc, again)["ok"] and all(d["kind"] == "neutral" for d in sim.diff_sim(doc, again)["deltas"])
    bad = sim.diff_sim(doc, worse)
    assert not bad["ok"] and {d["metric"] for d in bad["deltas"] if d["kind"] == "regression"} == {
        "fairness_jain", "ttft_s_p99"}
    assert sim.sim_comparability_problems(doc, refit) and sim.sim_comparability_problems(doc, other)
    assert not sim.diff_sim(doc, other)["comparable"]


def test_service_model_from_load_doc_and_workload_equal_jax():
    doc = {"n": 3, "summary": {"ttft_s": {"p50": 0.01, "p99": 0.03}, "tpot_s": {"p50": 0.001, "p99": 0.002}}}
    model, jmodel = sim.ServiceTimeModel.from_load_doc(doc), jax_sim.ServiceTimeModel.from_load_doc(doc)
    assert model.to_dict() == jmodel.to_dict() and model.source == "LOAD_r3"
    assert sim.ServiceTimeModel.from_load_doc(doc, source="mine").source == "mine"
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    draws = [(model.sample_prefill(rng), model.sample_tpot(rng)) for _ in range(500)]
    assert draws == [(jmodel.sample_prefill(jrng), jmodel.sample_tpot(jrng)) for _ in range(500)]
    prefill = sorted(d[0] for d in draws)
    assert prefill[250] == pytest.approx(0.01, rel=0.15)
    for bad in ({"summary": {"ttft_s": {"p50": 0.01}}}, {}):
        with pytest.raises(ValueError, match="cannot fit"):
            sim.ServiceTimeModel.from_load_doc(bad)
    with pytest.raises(ValueError):
        sim.ServiceTimeModel(prefill_p50_s=0.0, prefill_p99_s=1.0, tpot_p50_s=1.0, tpot_p99_s=1.0)

    specs, offsets = sim.build_multi_tenant_workload(_tenants(sim, 20, share=12))
    jspecs, joffsets = jax_sim.build_multi_tenant_workload(_tenants(jax_sim, 20, share=12))
    assert offsets == joffsets and [s.index for s in specs] == list(range(len(specs)))
    for s, j in zip(specs, jspecs):
        assert (s.index, s.tenant, s.prompt_len, s.max_new_tokens, s.rng_seed) == (
            j.index, j.tenant, j.prompt_len, j.max_new_tokens, j.rng_seed)
        assert np.array_equal(np.asarray(s.input_ids), np.asarray(j.input_ids))
    assert [t.to_dict() for t in _tenants(sim, share=12)] == [t.to_dict() for t in _tenants(jax_sim, share=12)]
    with pytest.raises(ValueError, match="duplicate"):
        sim.build_multi_tenant_workload([sim.TenantSpec("dup", rate_rps=1.0, n_requests=1)] * 2)
    with pytest.raises(ValueError, match="shared_prefix_len"):
        sim.TenantSpec("a", rate_rps=1.0, n_requests=1, prompt_lens=(8,), shared_prefix_len=8)
    for shares in ([0.5, 0.5, 0.5], [1.0, 0.0, 0.0, 0.0], [], [0.2, 0.9]):
        assert sim.jain_fairness(shares) == jax_sim.jain_fairness(shares)


def test_sim_frontend_refuses_what_jax_refuses():
    with pytest.raises(TypeError, match="ManualClock"):
        sim.SimEngineFrontEnd(service_model=sim.ServiceTimeModel(**MODEL), clock=time.monotonic)
    with pytest.raises(ValueError, match="non-speculative"):
        sim.SimEngineFrontEnd(service_model=sim.ServiceTimeModel(**MODEL),
                              engine_config=serving.EngineConfig(spec_k=2))
    fe = sim.SimEngineFrontEnd(service_model=sim.ServiceTimeModel(**MODEL), registry=MetricsRegistry())
    assert fe.model is None and fe.device is None and fe.books()["balanced"]
    assert dataclasses.asdict(fe.engine_config) == dataclasses.asdict(jax_serving.EngineConfig())
